"""Process groups (port of ``deeprank2_tpu/parallel/cluster.py``).

The JAX package runs one controller over a mesh of devices; the port runs
one process a rank (SPMD). :func:`initialize` joins the process group,
:func:`rank_device` gives each rank its card, and :func:`hybrid_mesh` cuts
the world into the ``(dp, gp)`` groups of the JAX mesh: ``dp`` across hosts
(large, infrequent gradient all-reduces), ``gp`` within a host (the
per-layer gathers of graph parallelism). A single process passes through
unchanged, as in JAX.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from deeprank2_tpu_torch.device import resolve_device

_log = logging.getLogger(__name__)

DEFAULT_TIMEOUT = timedelta(minutes=5)


def initialize(
    backend: str,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Join the process group (a no-op for a single process).

    ``backend`` is ``"gloo"`` or ``"nccl"``, always named by the caller.
    ``init_method`` is ``"env://"`` (``MASTER_ADDR``/``MASTER_PORT``, and
    ``WORLD_SIZE``/``RANK`` when not given) or a ``file://`` store; every
    collective of the group gives up after ``timeout``."""
    size = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if size == 1:
        _log.info("single-process run; no process group")
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    dist.init_process_group(backend=backend, init_method=init_method or "env://", world_size=size, rank=rank, timeout=timeout)
    _log.info(f"joined process group: rank {rank}/{size} ({backend})")


def local_rank() -> int:
    """This process's rank on its host (``LOCAL_RANK``, else its global rank)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(kind: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}`` (ranks beyond
    the host's cards share them), or the CPU when ``kind="cpu"``."""
    if kind == "cpu":
        return resolve_device("cpu")
    dev = resolve_device(kind)
    return torch.device("cuda", local_rank() % torch.cuda.device_count()) if dev.index is None else dev


@dataclass(frozen=True)
class Mesh:
    """The ``(dp, gp)`` grid of ranks: this rank's two groups (None for the
    default group of the whole world), their sizes and this rank's place in
    each."""

    dp: int
    gp: int
    dp_group: object
    gp_group: object
    dp_rank: int
    gp_rank: int


def hybrid_mesh(dp: int | None = None, gp: int | None = None, timeout: timedelta = DEFAULT_TIMEOUT) -> Mesh:
    """A ``(dp, gp)`` mesh: ``dp`` across hosts, ``gp`` within a host.

    Defaults: ``dp`` = the number of hosts (world size over
    ``LOCAL_WORLD_SIZE``), ``gp`` = the ranks a host. Ranks are host-major,
    so a gp group stays within a host. Every rank must call this with the
    same arguments (``dist.new_group`` is collective)."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dp is None:
        dp = max(1, size // int(os.environ.get("LOCAL_WORLD_SIZE", size)))
    if gp is None:
        gp = max(1, size // dp)
    if dp * gp != size:
        msg = f"mesh {dp}x{gp} does not cover {size} devices"
        raise ValueError(msg)
    if size == 1:
        return Mesh(1, 1, None, None, 0, 0)
    dp_group = gp_group = None
    for g in range(gp):  # the dp groups: one rank of each host
        ranks = [d * gp + g for d in range(dp)]
        group = dist.new_group(ranks, timeout=timeout) if dp < size else None
        if rank in ranks:
            dp_group = group
    for d in range(dp):  # the gp groups: the ranks of one host
        ranks = [d * gp + g for g in range(gp)]
        group = dist.new_group(ranks, timeout=timeout) if gp < size else None
        if rank in ranks:
            gp_group = group
    return Mesh(dp, gp, dp_group, gp_group, rank // gp, rank % gp)
