"""The whole step's share of the card's f32 peak (67 TFLOP/s on SXM; the
port computes in f32, TF32 off): the model operations of every batch the
window's passes took (forward, and for a train step its gradients, counted
from the shapes by the model module's ``flops``) over the window's wall
time. A train cell's epoch-0 forwards count as forwards."""


def read(ctx, phase):
    if phase != ctx.phase or not ctx.passes:
        return None
    info = ctx.batch_info
    per_pass = {train: sum(ctx.model.flops(ctx.config, b, train) for b in info) for train in (False, True)}
    total = sum(per_pass[p["kind"] == "train"] * p["batches"] / len(info) for p in ctx.passes)
    return 100.0 * total / ctx.window_s / ctx.peak[1]
