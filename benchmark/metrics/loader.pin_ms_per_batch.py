"""Host milliseconds of pinning a fresh batch on the loader's thread: the
``loader.pin`` spans (``pin_memory`` of each of the batch's tensors), the
values of ``pin_s`` of ``Trainer.pass_stats`` over the window's passes of
the phase, one a batch collated afresh, over their count. None where every
batch came from the collate cache."""

from benchmark.harness.pass_counters import ms_per_fresh_batch


def read(ctx, phase):
    return ms_per_fresh_batch(ctx, phase, "pin_s")
