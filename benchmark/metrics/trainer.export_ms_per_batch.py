"""Host milliseconds a batch of the drain's export, the device idle behind
it: the ``trainer.export`` spans (the per-graph ``Trainer._export_outputs``
loop and the exporters' ``process``), ``export_s`` of
``Trainer.pass_stats`` over the window's passes of the phase, over their
batches."""

from benchmark.harness.pass_counters import ms_per_batch


def read(ctx, phase):
    return ms_per_batch(ctx, phase, "export_s")
