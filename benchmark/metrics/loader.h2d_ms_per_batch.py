"""Device milliseconds of host-to-device copies a batch: the profiler's
``Memcpy HtoD`` time inside the window over every batch the window's passes
took (a train call's epoch-0 forward included)."""


def read(ctx, phase):
    batches = sum(p["batches"] for p in ctx.passes)
    if phase != ctx.phase or ctx.trace is None or not batches or ctx.trace.h2d_s <= 0:
        return None
    return 1e3 * ctx.trace.h2d_s / batches
