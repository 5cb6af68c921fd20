"""Graphs or grids trained a second: the samples of every train pass that
the window's ``Trainer.train`` calls ran, over the window's wall time (host
clock; the window closes once the device has finished)."""


def read(ctx, phase=None):  # noqa: ARG001
    if ctx.phase != "train":
        return None
    return ctx.samples / ctx.window_s
