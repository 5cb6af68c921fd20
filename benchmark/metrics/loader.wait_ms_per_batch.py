"""Host milliseconds a batch that the Trainer waits for the loader: the
``trainer.wait_batch`` spans (the queue's ``get``, the compute stream's wait
on the copy's event and ``record_stream``), ``wait_s`` of
``Trainer.pass_stats`` over the window's passes of the phase, over their
batches."""

from benchmark.harness.pass_counters import ms_per_batch


def read(ctx, phase):
    return ms_per_batch(ctx, phase, "wait_s")
