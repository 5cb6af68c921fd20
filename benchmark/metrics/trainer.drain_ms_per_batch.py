"""Host milliseconds a batch after the Trainer's pass loop: the drain that
reads the losses and predictions back and the per-graph export loop
(``_export_outputs``), ``seconds - loop_s`` of ``Trainer.pass_stats``
summed over the window's passes of the phase, over their batches."""


def read(ctx, phase):
    passes = [p for p in ctx.passes if p["kind"] == phase]
    batches = sum(p["batches"] for p in passes)
    if phase != ctx.phase or not batches:
        return None
    return 1e3 * sum(p["seconds"] - p["loop_s"] for p in passes) / batches
