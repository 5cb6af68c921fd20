"""K7's share of its roofline: the least time of its calls in the window
(bytes over the HBM rate or operations over the f32 rate, whichever is
longer, as the model module's ``k7_calls`` counts them at each batch's
shapes) over the device time of its two launches, ``row_offsets`` and
``sum_rows`` (``csrc/segment_sum.cu``). Every batch runs equally often in
the window, so a call's bound is the mean over the batches."""

from benchmark.harness.peaks import bound_s


def read(ctx, phase):
    if phase != ctx.phase or ctx.trace is None or not hasattr(ctx.model, "k7_calls"):
        return None
    seconds, _ = ctx.trace.kernel_time_s("row_offsets", "sum_rows")
    _, calls = ctx.trace.kernel_time_s("sum_rows")
    if not calls or seconds <= 0:
        return None
    per_batch = [ctx.model.k7_calls(b) for b in ctx.batch_info]
    mean_bound = sum(bound_s(c["bytes"], c["flop"], ctx.peak) for cs in per_batch for c in cs) / sum(len(cs) for cs in per_batch)
    return 100.0 * calls * mean_bound / seconds
