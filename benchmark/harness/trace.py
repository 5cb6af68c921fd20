"""The reduction of a ``torch.profiler`` trace of the window to what the
per-layer metrics read: the device's busy time (the union of its kernel,
copy and fill intervals inside the window), kernel launches and time by
name, host-to-device copy time, the host spans of the optimizer's steps,
the device time of chosen operators' subtrees, and the idle gaps named by
what the host's main thread was doing."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW_SPAN = "benchmark.window"
# operators whose subtree's device time a metric reads
OPS = ("aten::cudnn_convolution", "aten::convolution_backward")
SPAN_PREFIXES = ("Optimizer.step#",)


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_launches: int = 0
    h2d_s: float = 0.0
    device_s_by_name: dict = field(default_factory=dict)  # kernels and copies
    launches_by_name: dict = field(default_factory=dict)
    spans_s: dict = field(default_factory=dict)  # host span name -> durations
    op_device_s: dict = field(default_factory=dict)
    op_calls: dict = field(default_factory=dict)
    idle_gaps_s: dict = field(default_factory=dict)  # what the host did -> idle seconds

    def kernel_time_s(self, *parts: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose names hold any of ``parts``."""
        names = [n for n in self.launches_by_name if any(p in n for p in parts)]
        return sum(self.device_s_by_name[n] for n in names), sum(self.launches_by_name[n] for n in names)


def _is_device(event) -> bool:
    return str(event.device_type()).rsplit(".", 1)[-1] == "CUDA"


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def _innermost(ops: list[tuple[float, float, str]], starts: list[float], t: float, scan: int = 4000) -> str:
    """The innermost host op covering ``t`` on one thread (ops nest)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - scan), -1):
        if ops[j][1] >= t:
            return ops[j][2]
    return "python, outside any traced op"


def _containing(intervals: list[tuple[float, float, str]], starts: list[float], t: float) -> str | None:
    """The name of the interval (disjoint, sorted) that holds ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and intervals[i][1] >= t:
        return intervals[i][2]
    return None


def reduce(prof, named_gaps: int = 300) -> Summary:
    """Read the profiler's raw events (``kineto_results.events()``; times in
    ns, kept here in µs): device events by their own intervals, host events
    by thread, and each device event's launching host event by its linked
    correlation id."""
    events = prof.profiler.kineto_results.events()
    host, device = [], []
    for e in events:
        item = (e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3, e.name())
        if _is_device(e):
            device.append((*item, e.linked_correlation_id(), bool(getattr(e, "is_user_annotation", lambda: False)())))
        else:
            host.append((*item, e.start_thread_id(), e.correlation_id()))
    windows = [h for h in host if h[2] == WINDOW_SPAN]
    if not windows:
        msg = f"the trace holds no {WINDOW_SPAN!r} span"
        raise RuntimeError(msg)
    w0, w1, _, main, _ = windows[0]
    annotations = {h[2] for h in host if h[2].startswith(SPAN_PREFIXES)} | {WINDOW_SPAN}
    out = Summary(window_s=(w1 - w0) / 1e6, busy_s=0.0)
    # operators and annotations by their correlation id (a device event links
    # to the innermost one that launched it); the runtime API's own events
    # (cudaLaunchKernel, ...) carry ids of another space and are left out
    launcher = {h[4]: (h[0], h[3]) for h in host if h[4] > 0 and not h[2].startswith(("cuda", "cu", "Activity"))}
    # the chosen operators' intervals, by thread (an operator does not nest in itself)
    op_intervals: dict = defaultdict(list)
    spans, op_calls, host_ops = defaultdict(list), defaultdict(int), []
    for start, end, name, thread, _ in host:
        if end <= w0 or start >= w1 or name == WINDOW_SPAN:
            continue
        if thread == main:
            host_ops.append((start, end, name))
        if name.startswith(SPAN_PREFIXES):
            spans[name].append((end - start) / 1e6)
        if name in OPS:
            op_intervals[thread].append((start, end, name))
            op_calls[name] += 1
    for v in op_intervals.values():
        v.sort()
    op_starts = {t: [iv[0] for iv in v] for t, v in op_intervals.items()}
    busy = []
    device_us, launches, op_us = defaultdict(float), defaultdict(int), defaultdict(float)
    for start, end, name, link, annotation in device:
        if annotation or name in annotations or end <= w0 or start >= w1:
            continue
        s, t = max(start, w0), min(end, w1)
        busy.append((s, t))
        device_us[name] += t - s
        launches[name] += 1
        if not name.startswith(("Memcpy", "Memset")):
            out.kernel_launches += 1
        elif "HtoD" in name:
            out.h2d_s += (t - s) / 1e6
        if link in launcher:
            at, thread = launcher[link]
            if thread in op_intervals:
                op = _containing(op_intervals[thread], op_starts[thread], at)
                if op is not None:
                    op_us[op] += t - s
    merged = union(busy)
    out.busy_s = sum(b - a for a, b in merged) / 1e6
    out.device_s_by_name = {k: v / 1e6 for k, v in device_us.items()}
    out.launches_by_name = dict(launches)
    out.spans_s = dict(spans)
    out.op_device_s = {k: v / 1e6 for k, v in op_us.items()}
    out.op_calls = dict(op_calls)
    # idle gaps inside the window, the longest named by the host's main thread
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    host_ops.sort()
    starts = [op[0] for op in host_ops]
    named = defaultdict(float)
    for length, start in gaps[:named_gaps]:
        named[_innermost(host_ops, starts, start + length / 2)] += length / 1e6
    out.idle_gaps_s = dict(named)
    return out


def breakdown(summary: Summary, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps
    by what the host was doing, ``[name, seconds]`` each."""

    def short(name: str) -> str:
        return name if len(name) <= 120 else name[:117] + "..."

    ops = sorted(summary.device_s_by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary.idle_gaps_s.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[short(n), s] for n, s in ops], "idle_gaps": [[short(n), s] for n, s in gaps]}
