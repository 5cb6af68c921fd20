"""The convolutions' share of their roofline: the least time of the window's
convolution calls (each call's bytes over the HBM rate or its f32
operations over the f32 rate, whichever is longer, as the model module's
``conv_calls`` counts them) over the device time of every kernel launched
inside ``aten::cudnn_convolution`` (the forwards) and
``aten::convolution_backward`` (the data, weight and bias gradients)."""

from benchmark.harness.peaks import bound_s

OPS = {"forward": "aten::cudnn_convolution", "backward": "aten::convolution_backward"}


def read(ctx, phase):
    if phase != ctx.phase or ctx.trace is None or not hasattr(ctx.model, "conv_calls"):
        return None
    calls = ctx.model.conv_calls(ctx.config, int(ctx.traffic["batch_size"]))
    bound, seconds = 0.0, 0.0
    for kind, op in OPS.items():
        n = ctx.trace.op_calls.get(op, 0)
        if n:
            per_set = calls[kind]
            bound += n / len(per_set) * sum(bound_s(c["bytes"], c["flop"], ctx.peak) for c in per_set)
            seconds += ctx.trace.op_device_s.get(op, 0.0)
    return 100.0 * bound / seconds if seconds > 0 else None
