"""Seconds from the process's start to the window's: imports, the kernels'
build or load, the inputs and weights, the datasets, the Trainer and its
first calls."""


def read(ctx, phase=None):  # noqa: ARG001
    return ctx.setup_s
