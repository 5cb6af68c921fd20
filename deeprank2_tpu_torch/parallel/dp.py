"""Data-parallel training over a process group (port of
``deeprank2_tpu/parallel/dp.py``; the reference's ``nn.DataParallel``,
trainer.py:387).

Each rank holds one padded sub-batch, shard ``rank`` of the sharded
collates' shards (``ops/batch.py:collate_graphs_*_sharded``),
computes its loss and gradients locally, and the gradients and the loss are
averaged with one fused ``pmean`` (one all-reduce of a flat buffer) before a
replicated optimizer step, so the parameters stay equal on every rank.

Loss reporting note, as in JAX: the global loss is the pmean of per-shard
masked means; with unevenly filled shards it departs from the exact global
masked mean by the shard-count imbalance (standard DP behavior).
"""

from __future__ import annotations

import torch

from deeprank2_tpu_torch.parallel import comm


def shard_generator(step_seed: int, rank: int, device: torch.device) -> torch.Generator:
    """Dropout's generator for one rank at one step: seeded from the step's
    seed and the rank (the counterpart of JAX's ``fold_in(shard_base,
    axis_index)``), so every rank draws its own masks and a rerun draws the
    same."""
    return torch.Generator(device=device).manual_seed((step_seed * 1_000_003 + rank) % (1 << 63))


def sync_gradients(params: list[torch.nn.Parameter], loss: torch.Tensor, group=None) -> torch.Tensor:
    """Replace each parameter's ``.grad`` by its ``pmean`` over the group and
    return the loss's, all in one all-reduce of a flat f32 buffer (the JAX
    step's pmeans, which XLA fuses into one all-reduce). A parameter without
    a gradient counts as a zero one (the optimizers' rule)."""
    size, _ = comm.world(group)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [loss.detach().reshape(1).float()])
    flat = comm.all_reduce_sum(flat, group) / size
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = flat[offset : offset + n].reshape(p.shape).to(p.dtype)
        offset += n
    return flat[offset]


def make_dp_train_step(compute_loss, optimizer: torch.optim.Optimizer, group=None):
    """The data-parallel train step.

    ``compute_loss(batch, generator, training) -> (loss, pred)`` runs on this
    rank's shard. Returns ``step(local_batch, base_generator) -> (loss,
    pred)``: one seed a step from ``base_generator`` (a CPU generator, equal
    on every rank), dropout from :func:`shard_generator`, local loss and
    gradients, their pmean, the optimizer step (identical on every rank),
    and ``pred`` gathered to ``[D, G, ...]``."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    _, rank = comm.world(group)

    def step(batch, base_generator: torch.Generator):
        step_seed = int(torch.randint(0, 1 << 62, (), generator=base_generator))
        device = params[0].device
        optimizer.zero_grad(set_to_none=True)
        loss, pred = compute_loss(batch, shard_generator(step_seed, rank, device), True)
        loss.backward()
        mean_loss = sync_gradients(params, loss, group)
        optimizer.step()
        return mean_loss, comm.all_gather_rows(pred.detach()[None], group)

    return step


def make_dp_eval_step(compute_loss, group=None):
    """The data-parallel eval step: ``step(local_batch) -> (loss, pred)``,
    the loss pmean'ed and ``pred`` gathered to ``[D, G, ...]``."""

    @torch.no_grad()
    def step(batch):
        loss, pred = compute_loss(batch, None, False)
        size, _ = comm.world(group)
        return comm.all_reduce_sum(loss.reshape(1).float(), group)[0] / size, comm.all_gather_rows(pred[None], group)

    return step
