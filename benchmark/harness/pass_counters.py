"""What the per-layer readers of the Trainer's counters share: a counter
of ``Trainer.pass_stats`` (a pass's sum of one span's host seconds, or a
list of them, one a batch collated afresh), over the window's passes of the
cell's phase. Both return None outside the phase, without batches, or where
a pass lacks the counter (a program from before it)."""

from __future__ import annotations


def _passes(ctx, phase, *keys: str) -> list[dict] | None:
    passes = [p for p in ctx.passes if p["kind"] == phase]
    if phase != ctx.phase or any(k not in p for p in passes for k in keys):
        return None
    return passes


def ms_per_batch(ctx, phase, key: str) -> float | None:
    """Milliseconds of ``key`` summed over the passes, over their batches."""
    passes = _passes(ctx, phase, key)
    batches = sum(p["batches"] for p in passes or ())
    return 1e3 * sum(p[key] for p in passes) / batches if batches else None


def ms_per_fresh_batch(ctx, phase, key: str) -> float | None:
    """Milliseconds of the values of the list ``key`` over their count. Only
    a program that keeps cache hits out of the lists (and so counts
    ``cache_hits``) is read."""
    passes = _passes(ctx, phase, key, "cache_hits")
    values = [v for p in passes or () for v in p[key]]
    return 1e3 * sum(values) / len(values) if values else None
