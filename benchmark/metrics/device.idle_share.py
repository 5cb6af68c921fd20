"""The device's idle share of the window: one less the union of its kernel,
copy and fill intervals over the traced window's length."""


def read(ctx, phase):
    if phase != ctx.phase or ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
