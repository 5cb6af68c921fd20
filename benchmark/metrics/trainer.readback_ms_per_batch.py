"""Host milliseconds a batch that the drain waits on the device: the
``trainer.readback`` spans (the copies of a pass's stacked losses and
concatenated predictions to the host, which wait for the pass's device
work), ``readback_s`` of ``Trainer.pass_stats`` over the window's passes of
the phase, over their batches."""

from benchmark.harness.pass_counters import ms_per_batch


def read(ctx, phase):
    return ms_per_batch(ctx, phase, "readback_s")
