"""Host milliseconds of a fresh batch's collate on the loader's thread: the
``loader.collate`` spans (the dataset's reads, the collate, the class-index
map and the host stats), the values of ``collate_s`` of
``Trainer.pass_stats`` over the window's passes of the phase, one a batch
collated afresh, over their count. None where every batch came from the
collate cache."""

from benchmark.harness.pass_counters import ms_per_fresh_batch


def read(ctx, phase):
    return ms_per_fresh_batch(ctx, phase, "collate_s")
