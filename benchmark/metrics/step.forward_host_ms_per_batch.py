"""Host milliseconds a batch of the model's forward and loss: the
``trainer.forward`` spans (their dispatch; the device runs behind them),
``forward_s`` of ``Trainer.pass_stats`` over the window's passes of the
phase, over their batches."""

from benchmark.harness.pass_counters import ms_per_batch


def read(ctx, phase):
    return ms_per_batch(ctx, phase, "forward_s")
