"""Graphs or grids scored a second by ``Trainer.test``, over the window's
wall time (host clock; the window closes once the device has finished)."""


def read(ctx, phase=None):  # noqa: ARG001
    if ctx.phase != "score":
        return None
    return ctx.samples / ctx.window_s
