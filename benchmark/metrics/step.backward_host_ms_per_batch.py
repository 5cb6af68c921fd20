"""Host milliseconds a batch of the backward: the ``trainer.backward``
spans (the dispatch of ``loss.backward()``), ``backward_s`` of
``Trainer.pass_stats`` over the window's train passes, over their
batches."""

from benchmark.harness.pass_counters import ms_per_batch


def read(ctx, phase):
    return ms_per_batch(ctx, phase, "backward_s")
