"""``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` at its start, in GiB."""


def read(ctx, phase=None):  # noqa: ARG001
    return ctx.memory_peak_bytes / 2**30 if ctx.memory_peak_bytes else None
