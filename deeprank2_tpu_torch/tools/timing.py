"""The timing of one call on the card, with the L2 cache flushed before each
call, shared by ``chip_smoke.py`` and the measurement scripts of this
package: the median CUDA-event time (the host's launch included) and the
device time of the call's own kernels from the profiler."""

from __future__ import annotations

import statistics

import torch


class Timer:
    """Median CUDA-event time of one call, with the L2 cache flushed before
    each call (the 50 MB L2 would otherwise hold much of a call's inputs).
    The flush reads a 128 MB buffer, so that the L2 holds clean lines: a
    flush by writing would leave ~50 MB of dirty lines for the timed call to
    write back."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.flush = torch.ones(32 * 2**20, dtype=torch.float32, device=device)
        self.sink = torch.empty((), dtype=torch.float32, device=device)
        self.flush_keys = None  # the flush's kernels in the profiler (launch_ms)

    def ms(self, fn, reps: int = 25, flush: bool = True) -> float:
        """``flush=False``: calls back to back, each finding the L2 as the
        previous call left it (warm)."""
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(reps):
            if flush:
                torch.sum(self.flush, dim=0, out=self.sink)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)

    def kernels(self, fn, reps: int = 10) -> list:
        """The kernels of ``reps`` calls of ``fn``, each after an L2 flush as
        :meth:`ms` times it, from the profiler, in the order they ran: (name,
        device µs) pairs, the flush's kernels among them."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                torch.sum(self.flush, dim=0, out=self.sink)
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events() if e.device_type.name == "CUDA" and e.self_device_time_total > 0), key=lambda e: e.time_range.start)
        return [(e.key, e.self_device_time_total) for e in kernels]

    def launch_ms(self, fn, launches: dict, reps: int = 10) -> dict:
        """The device time of a call's launches from the profiler: the median
        over ``reps`` calls (each after an L2 flush, as :meth:`ms` times it;
        the trace cut into calls at the flush's kernels, which are left out),
        so a call whose records the trace lost does not move it.
        ``launches`` maps a key to a substring of one kernel's name, or to ""
        for every kernel the call launches; a key no call's trace shows is
        None (not measured)."""
        if self.flush_keys is None:
            self.flush_keys = {name for name, _ in self.kernels(lambda: None, reps)}
        calls, flushing = [], False
        for name, us in self.kernels(fn, reps):
            if name in self.flush_keys:  # a flush (one launch or several) opens the next call
                if not flushing:
                    calls.append({})
                flushing = True
            else:
                flushing = False
                if calls:
                    calls[-1][name] = calls[-1].get(name, 0.0) + us
        out = {}
        for key, part in launches.items():
            per_call = [sum(us for name, us in call.items() if part in name) for call in calls]
            out[key] = (statistics.median(per_call) / 1e3 if per_call else 0.0) or None
        return out
