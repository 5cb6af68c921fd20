"""One spawner with a deadline, for the tests, ``chip_smoke.py`` and the
dry run (``tools/dryrun_multichip.py``).

:func:`run` (or :func:`start`, which returns before the ranks end)
starts ``world_size`` processes with the ``spawn`` method (a
parent that has initialized CUDA cannot ``fork``), joins them into one
process group over a ``file://`` store in a fresh temporary directory (so
concurrent test workers never race for a port), with ``timeout`` on the
group, and calls ``fn(rank, world_size, *args)`` in each. Each rank's
return value comes back to the parent (through ``torch.save``), in rank
order. When a rank fails, or the deadline passes, every rank is killed and
the parent raises with the failing rank's traceback.

``fn`` must be importable by name: a spawned child imports the module that
defines it, so rank functions live in this package (never in a test
module, which imports JAX, or in a script's ``__main__``). Kernels are
built by the caller before it spawns (``ops/_build.py`` takes no file
lock), so two ranks never race on one library.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from deeprank2_tpu_torch.parallel import cluster


class RankFailed(RuntimeError):
    """A rank raised, died, or outlived the deadline."""


def _rank_main(fn, rank: int, world_size: int, workdir: str, backend: str, timeout_s: float, threads: int | None, args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    try:
        cluster.initialize(backend, f"file://{workdir}/store", world_size, rank, timeout=timedelta(seconds=timeout_s))
        result = fn(rank, world_size, *args)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """Ranks started by :func:`start`; :meth:`result` waits for them."""

    def __init__(self, fn, world_size: int, args: tuple, backend: str, timeout: float, deadline: float, threads: int | None):
        self._dir = tempfile.TemporaryDirectory(prefix="dr2-ranks-")
        ctx = mp.get_context("spawn")
        self._procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, self._dir.name, backend, timeout, threads, args), daemon=True) for r in range(world_size)]
        self._end = time.monotonic() + deadline
        self._deadline = deadline
        for p in self._procs:
            p.start()

    def result(self) -> list:
        """Every rank's return value, in rank order; raises
        :class:`RankFailed` (after killing every rank) when one fails or the
        deadline passes."""
        procs, workdir = self._procs, self._dir.name
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    raise RankFailed(_failure(workdir, failed, procs))
                if time.monotonic() > self._end:
                    raise RankFailed(f"ranks still running after the {self._deadline:.0f} s deadline")
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if failed:
                raise RankFailed(_failure(workdir, failed, procs))
            return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(len(procs))]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10)
            self._dir.cleanup()


def start(fn, world_size: int, *args, backend: str = "gloo", timeout: float = 120.0, deadline: float = 300.0, threads: int | None = None) -> Ranks:
    """Start ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes of one process group and return at once (the caller can work
    meanwhile); ``timeout`` bounds each collective (seconds), ``deadline``
    the whole run from now; ``threads`` sets each rank's intra-op thread
    count."""
    return Ranks(fn, world_size, args, backend, timeout, deadline, threads)


def run(fn, world_size: int, *args, **kwargs) -> list:
    """``[fn(rank, world_size, *args) for each rank]``: :func:`start`, then
    wait for the result."""
    return start(fn, world_size, *args, **kwargs).result()


def _failure(workdir: str, failed: list[int], procs) -> str:
    lines = []
    for r in failed:
        err = os.path.join(workdir, f"rank{r}.err")
        text = open(err).read() if os.path.exists(err) else ""
        lines.append(f"rank {r} exited with {procs[r].exitcode}\n{text}")
    return "\n".join(lines)
