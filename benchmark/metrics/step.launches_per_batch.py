"""CUDA kernel launches a batch: kernels (not copies or fills) in the
profiler's trace of the window over every batch the window's passes took."""


def read(ctx, phase):
    batches = sum(p["batches"] for p in ctx.passes)
    if phase != ctx.phase or ctx.trace is None or not batches:
        return None
    return ctx.trace.kernel_launches / batches
