"""Host milliseconds a batch in the Trainer's pass loop: the sum of
``loop_s`` over the sum of ``batches`` of the window's passes of the phase
(``Trainer.pass_stats``; train passes, not the epoch-0 forward of each
``train`` call)."""


def read(ctx, phase):
    passes = [p for p in ctx.passes if p["kind"] == phase]
    batches = sum(p["batches"] for p in passes)
    if phase != ctx.phase or not batches:
        return None
    return 1e3 * sum(p["loop_s"] for p in passes) / batches
