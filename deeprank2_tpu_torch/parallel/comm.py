"""The collectives of the parallel paths (the port's counterpart of the
``jax.lax`` collectives that ``deeprank2_tpu/parallel`` uses inside
``shard_map``), each an autograd Function with its transpose written out:

- :func:`all_gather`: ``all_gather(x, axis=0, tiled=True)``; its transpose
  is a sum-scatter, computed as an ``all_reduce`` of the whole cotangent
  followed by the rank's own rows (the one collective that gloo takes on
  CUDA tensors without doubt);
- :func:`psum` / :func:`pmean`: an ``all_reduce`` (sum, or sum over the
  group size); each is its own transpose;
- :func:`ppermute`: the ring hop ``i -> i + 1``; its transpose is the hop
  ``i -> i - 1``.

These transposes make every rank's backward the transpose of the global
program with each rank's loss as a term of the objective: the gradient of a
replicated parameter is the ``pmean`` of the ranks' gradients, the rule of
the data-parallel step (``dp.sync_gradients``), for the graph-parallel
models too.

gloo's point-to-point ``send``/``recv`` take CPU tensors only, so under a
gloo group a CUDA tensor's hop always goes through pinned host memory (a
copy to the host, the exchange, a copy back), never by a retry after an
error; under nccl the device tensor is sent. ``all_reduce`` and
``all_gather`` take device tensors under both backends.

Every call adds one to ``counts[kind]["count"]`` and its bytes to
``counts[kind]["bytes"]`` (the result's bytes, as the JAX package's
``comm_shape`` reads them from the compiled HLO: the gathered array for
an all-gather, the reduced array for an all-reduce, the moved block for a
permute); ``comm_shape`` reads them over one step. The kinds are the HLO
names.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

KINDS = ("all-reduce", "all-gather", "collective-permute")

# collectives since the last reset_counts(), by kind
counts = {kind: {"count": 0, "bytes": 0} for kind in KINDS}


def reset_counts() -> None:
    for kind in KINDS:
        counts[kind]["count"] = counts[kind]["bytes"] = 0


def snapshot() -> dict:
    """A copy of :data:`counts`."""
    return {kind: dict(v) for kind, v in counts.items()}


def _count(kind: str, t: torch.Tensor) -> None:
    counts[kind]["count"] += 1
    counts[kind]["bytes"] += t.numel() * t.element_size()


def world(group=None) -> tuple[int, int]:
    """``(size, rank)`` of ``group`` (the default group when None); ``(1, 0)``
    without an initialized process group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over the group, in a new tensor (not differentiable)."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    if world(group)[0] > 1:
        dist.all_reduce(out, group=group)
        _count("all-reduce", out)
    return out


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``t`` concatenated on axis 0, in rank order (not
    differentiable)."""
    size, _ = world(group)
    if size == 1:
        return t.detach().clone()
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    _count("all-gather", out)
    return out


def ring_hop(t: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """The block of rank ``i - shift``, received while ``t`` goes to rank
    ``i + shift`` (not differentiable). Under gloo a CUDA tensor is staged
    through pinned host memory (see the module docstring)."""
    size, rank = world(group)
    if size == 1:
        return t.detach().clone()
    src = t.detach().contiguous()
    staged = src.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        send = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        send.copy_(src)
    else:
        send = src
    recv = torch.empty_like(send)
    to = dist.get_global_rank(group, (rank + shift) % size) if group is not None else (rank + shift) % size
    frm = dist.get_global_rank(group, (rank - shift) % size) if group is not None else (rank - shift) % size
    reqs = [dist.isend(send, to, group=group), dist.irecv(recv, frm, group=group)]
    for req in reqs:
        req.wait()
    _count("collective-permute", recv)
    return recv.to(t.device) if staged else recv


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        _, rank = world(ctx.group)
        return all_reduce_sum(grad, ctx.group)[rank * ctx.rows : (rank + 1) * ctx.rows], None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_hop(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return ring_hop(grad, ctx.group, -1), None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=0, tiled=True)``: ``[rows, ...]``
    on each rank to ``[size * rows, ...]``, differentiable (the transpose
    sums the ranks' cotangents and keeps this rank's rows)."""
    return _AllGather.apply(x, group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``jax.lax.psum(x, axis)``, differentiable (its own transpose)."""
    return _Psum.apply(x, group)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``jax.lax.pmean(x, axis)``: :func:`psum` over the group size."""
    return psum(x, group) / world(group)[0]


def ppermute(x: torch.Tensor, group=None) -> torch.Tensor:
    """``jax.lax.ppermute(x, axis, [(i, (i + 1) % D)])``: this rank's block
    goes to the next rank and the previous rank's comes back,
    differentiable (the transpose hops back)."""
    return _Ppermute.apply(x, group)
