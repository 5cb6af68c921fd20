"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: they skip without a CUDA device. They import no JAX, so on a
GPU machine without JAX run them without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q
"""

from __future__ import annotations

import contextlib
import dataclasses
from unittest import mock

import pytest
import torch

import numpy as np

from deeprank2_tpu_torch.neuralnets.gnn.clustered_blocksparse import FoutNetBlockSparse, GINetClusteredBlockSparse, SGATBlockSparse
from deeprank2_tpu_torch.neuralnets.gnn.foutnet import FoutNetDiag
from deeprank2_tpu_torch.neuralnets.gnn.ginet_blocksparse import GINetBlockSparse
from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetClusteredDiag, GINetDense, set_dense_tower_backend
from deeprank2_tpu_torch.neuralnets.gnn.ginet import GINet
from deeprank2_tpu_torch.neuralnets.gnn.ginet_nocluster import GINet as GINetNoCluster
from deeprank2_tpu_torch.neuralnets.gnn.sgat import SGATDiag
from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetwork, VanillaNetworkBlocked
from deeprank2_tpu_torch.ops import block_sparse as bs
from deeprank2_tpu_torch.ops import blocked_edges as be
from deeprank2_tpu_torch.ops import diag_spmm as ds
from deeprank2_tpu_torch.ops import ginet_tower as gt
from deeprank2_tpu_torch.ops import segment_sorted as ss
from deeprank2_tpu_torch.ops import slotpool as sp
from deeprank2_tpu_torch.ops import vanilla as vn
from deeprank2_tpu_torch.ops.batch import (
    collate_graphs,
    collate_graphs_blocksparse,
    collate_graphs_blocked,
    collate_graphs_blocksparse_clustered,
    collate_graphs_dense,
    collate_graphs_diag_clustered,
)
from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
from deeprank2_tpu_torch.ops.synthetic import clustered_entry, geometric_entry, ppi_clustered_entries, signed_int8_blocks, synthetic_entries

pytestmark = pytest.mark.cuda
TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(g, n, f, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    adj = torch.rand(g, n, n, generator=gen) < 0.1
    adj = adj | adj.transpose(1, 2)
    mask = torch.ones(g, n, dtype=torch.bool)
    mask[:, n - n // 5 :] = False
    adj &= mask[:, :, None] & mask[:, None, :]
    x = torch.randn(f, g * n, generator=gen)
    g_pool = torch.randn(f, g, generator=gen)
    return adj.to(torch.int8).to(dev), mask.to(dev), x.to(dev), g_pool.to(dev)


# N=416 needs more than 48 KB of dynamic shared memory, N=336 more than 48 KB
# of dynamic and static together; F=70 leaves a ragged feature chunk
@pytest.mark.parametrize(("g", "n", "f"), [(3, 32, 8), (5, 100, 70), (2, 416, 33), (2, 336, 32)])
def test_kernels_match_plain_versions(cuda, g, n, f) -> None:
    adj, mask, x, g_pool = _operands(g, n, f, cuda)
    torch.testing.assert_close(ds.diag_kernel(adj, x), ds.diag_kernel_ref(adj, x), **TOL)
    h = ds.diag_kernel_ref(adj, x, mask, "relu_mask")
    torch.testing.assert_close(ds.diag_kernel(adj, x, mask, "relu_mask"), h, **TOL)
    sign, pooled = ds.diag_kernel(adj, x, mask, "relu_mask_pool")
    sign_ref, pooled_ref = ds.diag_kernel_ref(adj, x, mask, "relu_mask_pool")
    torch.testing.assert_close(pooled, pooled_ref, **TOL)
    assert not ((sign != sign_ref) & (h.abs() > TOL["atol"])).any()
    torch.testing.assert_close(ds.pool_bwd_kernel(adj, sign_ref, g_pool), ds.pool_bwd_kernel_ref(adj, sign_ref, g_pool), **TOL)


def test_kernel_raises_on_nodes_beyond_shared_memory(cuda) -> None:
    adj, _, x, _ = _operands(1, 2048, 4, cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ds.diag_kernel(adj, x)


def test_train_step_matches_cpu_and_counts_launches(cuda) -> None:
    entries = synthetic_entries(6, 40, 38, 6, seed=2)
    batch, _ = collate_graphs_dense(entries, pad_graphs=8, pad_nodes=64, device=cuda)
    model = GINetDense(38, 2, 6, device=cuda)
    cpu_model = GINetDense(38, 2, 6, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loss_fn = CrossEntropyLoss()
    ds.reset_launches()
    loss = loss_fn(model(batch), batch.y, batch.y_mask)
    loss.backward()
    assert ds.launches == {"diag_kernel": 3, "pool_bwd_kernel": 1, "tower_fwd_kernel": 0, "tower_bwd_kernel": 0}
    cpu_batch = batch.to("cpu")
    cpu_loss = loss_fn(cpu_model(cpu_batch), cpu_batch.y, cpu_batch.y_mask)
    cpu_loss.backward()
    torch.testing.assert_close(loss.detach().cpu(), cpu_loss.detach(), rtol=1e-4, atol=1e-6)
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        if p.grad is None:
            assert q.grad is None, name
        else:
            torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=1e-4, atol=1e-6, msg=name)


def _slot_operands(f, v, dev, seed=0):
    """Non-negative h with masked lanes zeroed, an exact tie and an all-zero group."""
    gen = torch.Generator().manual_seed(seed)
    mask = (torch.rand(1, v, generator=gen) > 0.1).float()
    h = torch.randn(f, v, generator=gen).abs()
    h[:, 16:24] = 0.0
    h[1, 40] = h[1, 41] = 3.0
    h = h * mask
    return h.to(dev), mask.to(dev), torch.randn(f, v, generator=gen).to(dev)


# a multiple of 1024 lanes, and a ragged width
@pytest.mark.parametrize("slot", [8, 4, 2])
@pytest.mark.parametrize(("f", "v"), [(32, 4096), (38, 8 * 1000 + 8 * 3)])
def test_slot_kernels_match_plain_versions_exactly(cuda, slot, f, v) -> None:
    h, mask, cot = _slot_operands(f, v, cuda, seed=slot)
    pooled = sp.slot_fwd_kernel(h, slot)
    torch.testing.assert_close(pooled, sp.slot_fwd_kernel_ref(h, slot), rtol=0, atol=0)
    g = cot[:, : v // slot].contiguous()
    torch.testing.assert_close(sp.slot_bwd_kernel(h, mask, pooled, g, slot), sp.slot_bwd_kernel_ref(h, mask, pooled, g, slot), rtol=0, atol=0)


def test_slot_kernels_match_plain_versions_at_mixed_regions(cuda) -> None:
    """Each size-class region of a mixed batch, cut as diag_depth0_pool cuts
    it: V = G * region width, at the region's stride, with its mask slice."""
    entries = ppi_clustered_entries(6, 40, 38, cell=6.0, seed=2)
    batch, _ = collate_graphs_diag_clustered(entries, pad_graphs=8, min_slot_nodes=5, device=cuda)
    g = batch.node_mask.shape[0]
    m3 = batch.node_mask.float()
    off = 0
    for slot, ns in zip((8, 4, 2), batch.region_caps[:3]):
        assert ns, batch.region_caps
        mask = m3[:, off : off + ns].contiguous().reshape(1, g * ns)
        h, _, cot = _slot_operands(19, g * ns, cuda, seed=slot)
        h = h * mask
        g_pool = cot[:, : g * ns // slot].contiguous()
        x, x_ref = h.clone().requires_grad_(True), h.clone().requires_grad_(True)
        out, out_ref = sp.slot_group_max(x, mask, slot=slot), sp.slot_group_max_ref(x_ref, mask, slot=slot)
        torch.testing.assert_close(out, out_ref, rtol=0, atol=0)
        (dh,), (dh_ref,) = torch.autograd.grad(out, x, g_pool), torch.autograd.grad(out_ref, x_ref, g_pool)
        torch.testing.assert_close(dh, dh_ref, rtol=0, atol=0)
        off += ns


def test_clustered_train_step_matches_cpu_and_counts_launches(cuda) -> None:
    entries = ppi_clustered_entries(6, 40, 38, cell=6.0, seed=2)
    for msn, per_forward in ((1, 1), (5, 3)):
        batch, _ = collate_graphs_diag_clustered(entries, pad_graphs=8, min_slot_nodes=msn, device=cuda)
        model = GINetClusteredDiag(38, 2, 1, device=cuda)
        cpu_model = GINetClusteredDiag(38, 2, 1, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        loss_fn = CrossEntropyLoss()
        ds.reset_launches()
        sp.reset_launches()
        loss = loss_fn(model(batch), batch.y, batch.y_mask)
        loss.backward()
        assert ds.launches["diag_kernel"] == 4
        assert sp.launches == {"slot_fwd_kernel": per_forward, "slot_bwd_kernel": per_forward}
        cpu_batch = batch.to("cpu")
        cpu_loss = loss_fn(cpu_model(cpu_batch), cpu_batch.y, cpu_batch.y_mask)
        cpu_loss.backward()
        torch.testing.assert_close(loss.detach().cpu(), cpu_loss.detach(), rtol=1e-4, atol=1e-5)
        for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
            if p.grad is None:
                assert q.grad is None, name
            else:
                torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=1e-4, atol=1e-6, msg=name)


def _locality_pairs(n, seed):
    entry = geometric_entry(n, 4, 1, seed=seed)
    inv = np.empty(n, dtype=np.int64)
    inv[bs.locality_order(entry["pos"])] = np.arange(n)
    return inv[entry["edge_index"]]


POOLED_NODES = 2304  # 18 row tiles, as the clustered BCSR path's pooled structure


def _bcsr_pairs(n):
    """The undirected pairs of a BCSR test structure and its node count: a
    locality-ordered geometric graph of ``n`` nodes, an edgeless one for 0,
    or for ``"pooled"`` the regime of the pooled structures: 18 row tiles of
    denser blocks (each node linked to 24 nodes within 200 of it, around the
    ring, so no node is a hub)."""
    if n == "pooled":
        rng = np.random.default_rng(18)
        src = np.repeat(np.arange(POOLED_NODES), 24)
        dst = (src + rng.integers(-200, 201, src.size)) % POOLED_NODES
        return np.stack([src, dst], axis=1), POOLED_NODES
    return (_locality_pairs(n, seed=n) if n else np.zeros((0, 2), np.int64)), max(n, 10)


# several chunks with trailing capacity-pad batches (F=38: one 64-feature
# slice, ragged; F=19: one 32-feature slice; F=16: one 16-feature slice), one
# chunk at F=64 and F=70 (two slices), an empty graph, and the pooled regime
# (18 row tiles: the destination nodes split in groups)
@pytest.mark.parametrize(
    ("n", "chunk_tiles", "f"),
    [(2200, 3, 38), (2200, 3, 19), (2200, 3, 16), (1500, None, 64), (1500, None, 70), (0, None, 32), ("pooled", None, 64), ("pooled", None, 16)],
)
def test_bcsr_kernel_matches_plain_version(cuda, n, chunk_tiles, f) -> None:
    pairs, nodes = _bcsr_pairs(n)
    st = bs.build_blocksparse(pairs, nodes, chunk_tiles=chunk_tiles, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(f)
    x = torch.randn(f, st.padded_nodes, generator=gen, device=cuda)
    cot = torch.randn(f, st.padded_rows, generator=gen, device=cuda)
    bs.reset_launches()
    out = bs.bcsr_spmm_kernel(st, x)
    torch.testing.assert_close(out, bs.bcsr_spmm_kernel_ref(st, x), **TOL)
    assert bs.launches == {"bcsr_spmm_kernel": 1}
    # through the autograd Function: the gradient is the same SpMM of the cotangent
    xk = x.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(bs.bcsr_spmm_t(st, xk), xk, cot)
    torch.testing.assert_close(grad, bs.bcsr_spmm_kernel_ref(st, cot), **TOL)
    assert bs.launches == {"bcsr_spmm_kernel": 3}
    if not n:
        assert not out.any()


@pytest.mark.parametrize("kind", ["bcsr", "clustered_slot8"])
def test_blocksparse_train_step_matches_cpu_and_counts_launches(cuda, kind) -> None:
    if kind == "bcsr":
        entries = [geometric_entry(n, 38, 1, seed=i) for i, n in enumerate((700, 1300))]
        collate, cls, slot = collate_graphs_blocksparse, GINetBlockSparse, {"slot_fwd_kernel": 0, "slot_bwd_kernel": 0}
    else:
        entries = [clustered_entry(n, 38, seed=i) for i, n in enumerate((3000, 1300))]
        collate = lambda e, **kw: collate_graphs_blocksparse_clustered(e, slot8=True, **kw)  # noqa: E731
        cls, slot = GINetClusteredBlockSparse, {"slot_fwd_kernel": 1, "slot_bwd_kernel": 1}
    entries[1]["y"] = 0.0
    batch, _ = collate(entries, pad_graphs=3, device=cuda)
    model, cpu_model = cls(38, 2, 1, device=cuda), cls(38, 2, 1, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loss_fn = CrossEntropyLoss()
    for m in (bs, ds, sp):
        m.reset_launches()
    loss = loss_fn(model(batch), batch.y, batch.y_mask)
    loss.backward()
    assert bs.launches == {"bcsr_spmm_kernel": 4}
    assert sp.launches == slot and not any(ds.launches.values())
    cpu_batch = batch.to("cpu")
    cpu_loss = loss_fn(cpu_model(cpu_batch), cpu_batch.y, cpu_batch.y_mask)
    cpu_loss.backward()
    torch.testing.assert_close(loss.detach().cpu(), cpu_loss.detach(), rtol=1e-4, atol=1e-5)
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        if p.grad is None:
            assert q.grad is None, name
        else:
            torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=1e-4, atol=1e-6, msg=name)


def _blocked_structure(case, dev):
    """Structures from the blocked collate: ragged graphs with an edgeless
    graph and a padding graph, the same with three capacity-pad slabs, and no
    edges at all."""
    entries = [geometric_entry(700, 4, 6, seed=1), geometric_entry(1300, 4, 6, seed=2), geometric_entry(200, 4, 6, seed=3)]
    entries[2]["edge_index"] = entries[2]["edge_index"][:0]
    entries[2]["edge_attr"] = entries[2]["edge_attr"][:0]
    if case == "no_edges":
        entries = entries[2:]
    batch, _ = collate_graphs_blocked(entries, pad_graphs=4, pad_slabs=(lambda req: req + 3) if case == "pads" else None, device=dev)
    return batch.structure


# M = 32 (8 lanes a node), 12, 5 and 38 (rows not a multiple of 4: masked
# loads), 136 (two feature slices)
BLOCKED_M = [32, 12, 5, 38, 136]


def _assert_blocked_order(st, xr, xc, w_e, g, out, dxr, dxc, compute_dtype=None) -> None:
    """K6f's out and K6b's dxr and dxc equal the float32 loop in ascending
    slot order (``blocked_order_ref``) bit for bit."""
    for name, got, want in zip(("out", "dxr", "dxc"), (out, dxr, dxc), vn.blocked_order_ref(st, xr, xc, w_e, g, compute_dtype)):
        torch.testing.assert_close(got, want, rtol=0, atol=0, msg=lambda m, name=name: f"{name}: {m}")


# f32 on both sides and the same pre-activations: out, dxr and dxc differ in
# summation order only; dw_e sums every edge's product, so its tolerance is
# 1e-6 of the sum of their absolute values
@pytest.mark.parametrize("m", BLOCKED_M)
@pytest.mark.parametrize("case", ["ragged", "pads", "no_edges"])
def test_blocked_kernels_match_plain_versions(cuda, case, m) -> None:
    st = _blocked_structure(case, cuda)
    gen = torch.Generator(device=cuda).manual_seed(m)
    xr, xc, g = (torch.randn(st.padded_nodes, m, generator=gen, device=cuda) for _ in range(3))
    w_e = torch.randn(st.edge_dim, m, generator=gen, device=cuda)
    vn.reset_launches()
    out = vn.blocked_fwd_kernel(st, xr, xc, w_e)
    torch.testing.assert_close(out, vn.blocked_fwd_kernel_ref(st, xr, xc, w_e), **TOL)
    dxr, dxc, dw_e = vn.blocked_bwd_kernel(st, xr, xc, w_e, g)
    want = vn.blocked_bwd_kernel_ref(st, xr, xc, w_e, g)
    torch.testing.assert_close(dxr, want[0], **TOL)
    torch.testing.assert_close(dxc, want[1], **TOL)
    torch.testing.assert_close(dw_e, want[2], rtol=1e-5, atol=1e-6 * vn.dw_error_scale(st, g).max().item() + 1e-6)
    _assert_blocked_order(st, xr, xc, w_e, g, out, dxr, dxc)
    assert vn.launches == {"blocked_fwd_kernel": 1, "blocked_bwd_kernel": 1}
    # through the autograd Function
    args = [t.clone().requires_grad_(True) for t in (xr, xc, w_e)]
    out_fn = be.blocked_message_sum(st, *args)
    grads = torch.autograd.grad(out_fn, args, g)
    assert vn.launches == {"blocked_fwd_kernel": 2, "blocked_bwd_kernel": 2}
    torch.testing.assert_close(out_fn.detach(), out, rtol=0, atol=0)
    for got, ref in zip(grads, (dxr, dxc, dw_e)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)  # deterministic: no atomics
    if case == "no_edges":
        assert not out.any() and not dxr.any() and not dxc.any() and not dw_e.any()


def test_blocked_kernels_take_rows_off_their_vector_alignment(cuda) -> None:
    """Node arrays whose rows start off a 16-byte boundary take the masked
    loads: the same sums, in the same order."""
    st = _blocked_structure("ragged", cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    v, m = st.padded_nodes, 32
    xr, xc, g = (torch.randn(v * m + 1, generator=gen, device=cuda)[1:].view(v, m) for _ in range(3))
    assert xr.data_ptr() % 16 and xr.is_contiguous()
    w_e = torch.randn(st.edge_dim, m, generator=gen, device=cuda)
    dxr, dxc, dw_e = vn.blocked_bwd_kernel(st, xr, xc, w_e, g)
    _assert_blocked_order(st, xr, xc, w_e, g, vn.blocked_fwd_kernel(st, xr, xc, w_e), dxr, dxc)
    torch.testing.assert_close(dw_e, vn.blocked_bwd_kernel_ref(st, xr, xc, w_e, g)[2], rtol=1e-5, atol=1e-6 * vn.dw_error_scale(st, g).max().item() + 1e-6)


def test_blocked_train_step_matches_cpu_and_counts_launches(cuda) -> None:
    entries = [geometric_entry(n, 38, 6, seed=i) for i, n in enumerate((700, 1300))]
    entries[1]["y"] = 0.0
    batch, _ = collate_graphs_blocked(entries, pad_graphs=3, device=cuda)
    model, cpu_model = VanillaNetworkBlocked(38, 2, 6, device=cuda), VanillaNetworkBlocked(38, 2, 6, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loss_fn = CrossEntropyLoss()
    for m in (bs, ds, sp, vn):
        m.reset_launches()
    loss = loss_fn(model(batch), batch.y, batch.y_mask)
    loss.backward()
    assert vn.launches == {"blocked_fwd_kernel": 2, "blocked_bwd_kernel": 2}
    assert not any(v for m in (bs, ds, sp) for v in m.launches.values())
    cpu_batch = batch.to("cpu")
    cpu_loss = loss_fn(cpu_model(cpu_batch), cpu_batch.y, cpu_batch.y_mask)
    cpu_loss.backward()
    torch.testing.assert_close(loss.detach().cpu(), cpu_loss.detach(), rtol=1e-4, atol=1e-5)
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=1e-4, atol=1e-6, msg=name)


# F = 12, 16, 32 and one past a warp; padding at n + 7; empty segments; E = 0
@pytest.mark.parametrize(("num_edges", "num_segments", "f"), [(5000, 700, 12), (5000, 700, 16), (20000, 3000, 32), (3000, 200, 70), (0, 50, 16)])
def test_segment_kernel_matches_plain_version(cuda, num_edges, num_segments, f) -> None:
    gen = torch.Generator().manual_seed(num_edges + f)
    rows = torch.sort(torch.randint(0, num_segments, (num_edges,), generator=gen)).values.to(torch.int32)
    rows[(rows > 10) & (rows < 20)] = 5  # segments 11-19 empty, still ascending
    rows = torch.sort(rows).values
    if num_edges:
        rows[-37:] = num_segments + 7
    msgs = torch.randn(num_edges, f, generator=gen).to(cuda)
    rows, cot = rows.to(cuda), torch.randn(num_segments, f, generator=gen).to(cuda)
    ss.reset_launches()
    out = ss.segment_sum_sorted_kernel(msgs, rows, num_segments)
    torch.testing.assert_close(out, ss.segment_sum_sorted_kernel_ref(msgs, rows, num_segments), **TOL)
    assert not out[11:20].any()
    assert ss.launches == {"segment_sum_sorted_kernel": 1}
    # through the autograd Function: the same launch, and a gather for the VJP
    m = msgs.clone().requires_grad_(True)
    out_fn = ss.segment_sum_sorted(m, rows, num_segments)
    (grad,) = torch.autograd.grad(out_fn, m, cot)
    torch.testing.assert_close(out_fn.detach(), out, rtol=0, atol=0)  # deterministic: no atomics
    want_grad = cot[rows.long().clamp(max=num_segments - 1)] * (rows < num_segments).float()[:, None]
    torch.testing.assert_close(grad, want_grad, rtol=0, atol=0)
    assert ss.launches == {"segment_sum_sorted_kernel": 2}


def _segment_case(case, n, f, dev):
    """Ascending rows (padding at n + 7 or n + 3) and messages of the K7
    cases; "misaligned" messages start one float past a 16-byte boundary."""
    gen = torch.Generator().manual_seed(f)
    if case == "no_edges":
        rows = torch.zeros(0, dtype=torch.int32)
    elif case == "all_padding":
        rows = torch.full((700,), n + 3, dtype=torch.int32)
    elif case == "long_run":  # segment 17 has 10^4 messages and more
        rows = torch.sort(torch.cat([torch.randint(0, n, (3000,), generator=gen), torch.full((10_000,), 17)])).values.to(torch.int32)
    else:  # segments 100-149 empty, 50 padding entries
        rows = torch.sort(torch.randint(0, n, (4000,), generator=gen)).values.to(torch.int32)
        rows[(rows >= 100) & (rows < 150)] = 99
        rows = torch.sort(rows).values
        rows[-50:] = n + 7
    e = rows.numel()
    store = torch.randn(e * f + 1, generator=gen).to(dev)
    msgs = (store[1:] if case == "misaligned" else store[:-1]).view(e, f)
    return msgs, rows.to(dev)


# F = 1 and 5 (a lane on a feature), 16 and 32 (lanes on feature quads, 8 and
# 4 rows a warp), 38 (not a multiple of 4) and 64; a run of 10^4 messages;
# only padding; no messages; messages off their 16-byte alignment. Each
# output row is the ascending f32 sum over its run (segment_sum_order_ref)
# bit for bit, two calls give the same bits, and empty segments are +0.
@pytest.mark.parametrize("f", [1, 5, 16, 32, 38, 64])
@pytest.mark.parametrize("case", ["ragged", "long_run", "all_padding", "no_edges", "misaligned"])
def test_segment_kernel_is_its_order_loop_bit_for_bit(cuda, case, f) -> None:
    n = 300
    msgs, rows = _segment_case(case, n, f, cuda)
    assert (msgs.data_ptr() % 16 != 0) == (case == "misaligned")
    ss.reset_launches()
    out = ss.segment_sum_sorted_kernel(msgs, rows, n)
    again = ss.segment_sum_sorted_kernel(msgs, rows, n)
    assert ss.launches == {"segment_sum_sorted_kernel": 2}
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    assert torch.equal(out.view(torch.int32), ss.segment_sum_order_ref(msgs, rows, n).view(torch.int32))
    counts = torch.bincount(rows[rows < n].long(), minlength=n)
    assert not out.view(torch.int32)[counts == 0].any()
    # against the plain version (index_add): f32 sums of up to 10^4 terms in
    # another order, atol 1e-6 of the largest sum of |terms|
    scale = ss.segment_sum_sorted_kernel_ref(msgs.abs(), rows, n).max().item() if rows.numel() else 0.0
    torch.testing.assert_close(out, ss.segment_sum_sorted_kernel_ref(msgs, rows, n), rtol=1e-5, atol=max(1e-5, 1e-6 * scale))


# (model, entries, edge features, K7 launches in one forward)
COO_MODELS = {
    "ginet_nocluster": (GINetNoCluster, lambda: synthetic_entries(6, 40, 38, 6, seed=2), 6, 4),
    "ginet": (GINet, lambda: ppi_clustered_entries(6, 40, 38, seed=2), 1, 4),
    "vanilla": (VanillaNetwork, lambda: synthetic_entries(6, 40, 38, 6, seed=2), 6, 2),
}


@pytest.mark.parametrize("kind", sorted(COO_MODELS))
def test_coo_train_step_matches_cpu_and_counts_launches(cuda, kind) -> None:
    cls, make, fe, per_forward = COO_MODELS[kind]
    entries = make()
    entries[1]["y"] = None
    batch, _ = collate_graphs(entries, pad_graphs=8, device=cuda)
    model, cpu_model = cls(38, 2, fe, device=cuda), cls(38, 2, fe, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loss_fn = CrossEntropyLoss()
    for m in (bs, ds, sp, vn, ss):
        m.reset_launches()
    loss = loss_fn(model(batch), batch.y, batch.y_mask)
    loss.backward()
    assert ss.launches == {"segment_sum_sorted_kernel": per_forward}  # the backward is a gather
    assert not any(v for m in (bs, ds, sp, vn) for v in m.launches.values())
    cpu_batch = batch.to("cpu")
    cpu_loss = loss_fn(cpu_model(cpu_batch), cpu_batch.y, cpu_batch.y_mask)
    cpu_loss.backward()
    torch.testing.assert_close(loss.detach().cpu(), cpu_loss.detach(), rtol=1e-4, atol=1e-5)
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        if p.grad is None:
            assert q.grad is None, name
        else:
            torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=1e-4, atol=1e-6, msg=name)


def test_vanilla_step_on_featurized_graphs_matches_cpu(cuda) -> None:
    """VanillaNetwork on residue graphs of the 1ATN decoys featurized by the
    port (the PPI tutorial's settings: 8 A, components and contact),
    turned into entries as ``chip_smoke.py`` does on this machine (no h5py):
    one train step card against CPU, K7 launched by both convs."""
    import runpy
    from pathlib import Path

    from deeprank2_tpu_torch.query import ProteinProteinInterfaceQuery

    root = Path(__file__).resolve().parent.parent
    smoke = runpy.run_path(str(root / "chip_smoke.py"), run_name="chip_smoke")
    entries = []
    for i, decoy in enumerate(("1ATN_1w", "1ATN_2w", "1ATN_3w")):
        query = ProteinProteinInterfaceQuery(
            pdb_path=str(root / "tests" / "data" / "pdb" / "1ATN" / f"{decoy}.pdb"),
            resolution="residue",
            chain_ids=["A", "B"],
            influence_radius=8.0,
            max_edge_length=8.0,
            targets={"binary": i % 2},
        )
        entries.append(smoke["graph_entry"](query.build(["components", "contact"]), ["res_type", "polarity"], ["distance", "covalent"]))
    batch, _ = collate_graphs(entries, pad_graphs=4, device=cuda)
    f, fe = entries[0]["x"].shape[1], entries[0]["edge_attr"].shape[1]
    model, cpu_model = VanillaNetwork(f, 2, fe, device=cuda), VanillaNetwork(f, 2, fe, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loss_fn = CrossEntropyLoss()
    ss.reset_launches()
    loss = loss_fn(model(batch), batch.y, batch.y_mask)
    loss.backward()
    assert ss.launches == {"segment_sum_sorted_kernel": 2}
    cpu_batch = batch.to("cpu")
    cpu_loss = loss_fn(cpu_model(cpu_batch), cpu_batch.y, cpu_batch.y_mask)
    cpu_loss.backward()
    torch.testing.assert_close(loss.detach().cpu(), cpu_loss.detach(), rtol=1e-4, atol=1e-5)
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=1e-4, atol=1e-6, msg=name)


def _tower_operands(g, n, f, c1, c2, dev, seed=0):
    """A symmetric 0/1 adjacency with a masked, edgeless tail in every graph,
    features in both layouts, the two weights and the pooled cotangents."""
    gen = torch.Generator().manual_seed(seed)
    adj = torch.rand(g, n, n, generator=gen) < 0.05
    adj = adj | adj.transpose(1, 2)
    mask = torch.ones(g, n, dtype=torch.bool)
    for i in range(g):
        mask[i, n - 1 - (7 * i) % (n // 3) :] = False
    adj &= mask[:, :, None] & mask[:, None, :]
    x = torch.randn(g, n, f, generator=gen)
    w1, w2 = torch.randn(f, c1, generator=gen) * 0.2, torch.randn(c1, c2, generator=gen) * 0.2
    dpooled = torch.randn(g, c2, generator=gen)
    out = (adj.to(torch.int8), mask, x, x.reshape(g * n, f).T.contiguous(), w1, w2, dpooled)
    return [t.to(dev) for t in out]


# the dense bench widths at a ragged G, at N = 251 (the largest N the flat
# tower's earlier plan admitted), and widths that are not multiples of 4 (padded channels);
# pooled and h1 sum f32 products in another order; dw1/dw2 sum one product
# per node and graph, and t1 cancels terms far larger than itself, so their
# atol is 1e-6 of the products' absolute sum (t2 likewise)
@pytest.mark.parametrize(("g", "n", "f", "c1", "c2"), [(7, 96, 38, 32, 64), (3, 251, 38, 32, 64), (5, 40, 5, 6, 10)])
def test_tower_kernels_match_plain_versions(cuda, g, n, f, c1, c2) -> None:
    assert gt.supports(g, n, f, c1, c2)
    adj, mask, x, x_t, w1, w2, dp = _tower_operands(g, n, f, c1, c2, cuda)
    gt.reset_launches()
    ds.reset_launches()
    torch.testing.assert_close(gt.ginet_tower_fwd_kernel(w1, w2, x, adj, mask), gt.ginet_tower_fwd_kernel_ref(w1, w2, x, adj, mask), **TOL)
    got, want = gt.ginet_tower_bwd_kernel(w1, w2, x, adj, mask, dp), gt.ginet_tower_bwd_kernel_ref(w1, w2, x, adj, mask, dp)
    for a, b, scale in zip(got, want, gt.dw_error_scale(w1, w2, x, adj, mask, dp)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * scale.max().item())
    assert gt.launches == {"ginet_tower_fwd_kernel": 1, "ginet_tower_bwd_kernel": 1}
    h1, sign, pooled = ds.tower_fwd_kernel(adj, x_t, mask, w1, w2)
    h1_r, sign_r, pooled_r = ds.tower_fwd_kernel_ref(adj, x_t, mask, w1, w2)
    torch.testing.assert_close(h1, h1_r, **TOL)
    torch.testing.assert_close(pooled, pooled_r, **TOL)
    h2 = torch.relu(ds.diag_kernel_ref(adj, w2.T @ h1_r)) * mask.reshape(1, -1)
    assert not ((sign != sign_r) & (h2.abs() > 1e-6 * h2.abs().max())).any()
    g_pool = dp.T.contiguous()
    bwd = (adj, g_pool, sign_r, h1_r, w2)
    for a, b, scale in zip(ds.tower_bwd_kernel(*bwd), ds.tower_bwd_kernel_ref(*bwd), ds.tower_bwd_error_scale(*bwd)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=max(1e-5, 1e-6 * scale.max().item()))
    assert ds.launches["tower_fwd_kernel"] == ds.launches["tower_bwd_kernel"] == 1


# Each kernel's own plan at these widths: K8f's and K9f's (the same plan) end
# at N = 400 (where tower_supports() ends), K8b's at N = 352 (where
# supports(), both, ends) and K9b's at N = 457. Beyond its plan a kernel
# raises; within it, it agrees with its plain version.
@pytest.mark.parametrize("n", [252, 353, 401, 445, 2048])
def test_tower_kernels_raise_beyond_the_shape_rule(cuda, n) -> None:
    adj, mask, x, x_t, w1, w2, dp = _tower_operands(1, n, 38, 32, 64, cuda)
    args = (w1, w2, x, adj, mask)
    fwd_fits, bwd_fits = gt.smem_bytes(n, 38, 32, 64) <= gt.SMEM_LIMIT, gt.bwd_smem_bytes(n, 38, 32, 64) <= gt.SMEM_LIMIT
    assert gt.supports(1, n) == (fwd_fits and bwd_fits) and fwd_fits == (n <= 400) and bwd_fits == (n <= 352)
    if fwd_fits:
        torch.testing.assert_close(gt.ginet_tower_fwd_kernel(*args), gt.ginet_tower_fwd_kernel_ref(*args), **TOL)
    else:
        with pytest.raises(RuntimeError, match="CUDA error"):
            gt.ginet_tower_fwd_kernel(*args)
    if bwd_fits:
        got, want = gt.ginet_tower_bwd_kernel(*args, dp), gt.ginet_tower_bwd_kernel_ref(*args, dp)
        for a, b, scale in zip(got, want, gt.dw_error_scale(*args, dp)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * scale.max().item())
    else:
        with pytest.raises(RuntimeError, match="CUDA error"):
            gt.ginet_tower_bwd_kernel(*args, dp)
    assert ds.tower_supports(1, n) == fwd_fits == (ds.tower_fwd_smem_bytes(n, 38, 32, 64) <= ds.SMEM_LIMIT)
    h1, sign, pooled = ds.tower_fwd_kernel_ref(adj, x_t, mask, w1, w2)
    if fwd_fits:
        got = ds.tower_fwd_kernel(adj, x_t, mask, w1, w2)
        torch.testing.assert_close(got[0], h1, **TOL)
        torch.testing.assert_close(got[2], pooled, **TOL)
    else:
        with pytest.raises(RuntimeError, match="CUDA error"):
            ds.tower_fwd_kernel(adj, x_t, mask, w1, w2)
    bwd = (adj, dp.T.contiguous(), sign, h1, w2)
    if ds.tower_bwd_smem_bytes(n, 32, 64) > ds.SMEM_LIMIT:
        assert n > 457
        with pytest.raises(RuntimeError, match="CUDA error"):
            ds.tower_bwd_kernel(*bwd)
    else:
        for a, b, scale in zip(ds.tower_bwd_kernel(*bwd), ds.tower_bwd_kernel_ref(*bwd), ds.tower_bwd_error_scale(*bwd)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=max(1e-5, 1e-6 * scale.max().item()))


def test_dense_tower_train_step_matches_cpu_and_counts_launches(cuda) -> None:
    entries = synthetic_entries(6, 40, 38, 6, seed=2)
    batch, _ = collate_graphs_dense(entries, pad_graphs=7, pad_nodes=64, device=cuda)
    model = GINetDense(38, 2, 6, device=cuda)
    cpu_model = GINetDense(38, 2, 6, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loss_fn = CrossEntropyLoss()
    set_dense_tower_backend("pallas")
    try:
        ds.reset_launches()
        gt.reset_launches()
        loss = loss_fn(model(batch), batch.y, batch.y_mask)
        loss.backward()
        assert gt.launches == {"ginet_tower_fwd_kernel": 1, "ginet_tower_bwd_kernel": 1}
        assert not any(ds.launches.values())
        cpu_batch = batch.to("cpu")
        cpu_loss = loss_fn(cpu_model(cpu_batch), cpu_batch.y, cpu_batch.y_mask)
        cpu_loss.backward()
    finally:
        set_dense_tower_backend("xla")
    torch.testing.assert_close(loss.detach().cpu(), cpu_loss.detach(), rtol=1e-4, atol=1e-6)
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        if p.grad is None:
            assert q.grad is None, name
        else:
            torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=1e-4, atol=1e-6, msg=name)


def test_tower_pooled_matches_plain_version_and_counts_launches(cuda) -> None:
    adj, mask, _, x_t, w1, w2, dp = _tower_operands(9, 80, 38, 32, 64, cuda, seed=3)
    ds.reset_launches()
    outs = []
    for fn in (ds.tower_pooled, ds.tower_pooled_ref):
        a, b = w1.clone().requires_grad_(True), w2.clone().requires_grad_(True)
        out = fn(adj, mask, x_t, a, b)
        outs.append((out.detach(), *torch.autograd.grad(out, (a, b), dp.T.contiguous())))
    assert ds.launches == {"diag_kernel": 0, "pool_bwd_kernel": 0, "tower_fwd_kernel": 1, "tower_bwd_kernel": 1}
    # dw1 and dw2 sum 720 node terms that cancel: atol relative to their size
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * want.abs().max().item())


def _weighted_adjacency(g, n, dtype, dev, seed=0):
    """A symmetric weighted adjacency (|N(0, 1)| + 0.1, summed over both
    directions) on 10 % of the pairs, or on 16 neighbours a node where that
    is fewer (a residue graph's degree: the sums stay of the size the
    models give the kernel), with a masked, edgeless tail, stored as
    ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    edges = torch.rand(g, n, n, generator=gen) < min(0.1, 16 / n)
    edges = edges | edges.transpose(1, 2)
    mask = torch.ones(g, n, dtype=torch.bool)
    mask[:, n - n // 5 :] = False
    edges &= mask[:, :, None] & mask[:, None, :]
    w = torch.randn(g, n, n, generator=gen).abs() + 0.1
    w = (w + w.transpose(1, 2)) * edges
    return w.to(dtype).to(dev), mask.to(dev)


# the sGAT widths (16, 32), a ragged one (38); N=336 and the largest N of
# each adjacency type need the shared-memory opt-in
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(("g", "n", "f"), [(5, 100, 16), (3, 64, 38), (2, 336, 32), (2, "max", 16)])
def test_weighted_diag_kernels_match_plain_versions(cuda, dtype, g, n, f) -> None:
    if n == "max":
        n = ds.max_nodes(dtype)
    adj, mask = _weighted_adjacency(g, n, dtype, cuda, seed=n)
    gen = torch.Generator(device=cuda).manual_seed(f)
    x = torch.randn(f, g * n, generator=gen, device=cuda)
    g_pool = torch.randn(f, g, generator=gen, device=cuda)
    ds.reset_launches()
    torch.testing.assert_close(ds.diag_kernel(adj, x), ds.diag_kernel_ref(adj, x), **TOL)
    h = ds.diag_kernel_ref(adj, x, mask, "relu_mask")
    torch.testing.assert_close(ds.diag_kernel(adj, x, mask, "relu_mask"), h, **TOL)
    sign, pooled = ds.diag_kernel(adj, x, mask, "relu_mask_pool")
    sign_ref, pooled_ref = ds.diag_kernel_ref(adj, x, mask, "relu_mask_pool")
    torch.testing.assert_close(pooled, pooled_ref, **TOL)
    assert not ((sign != sign_ref) & (h.abs() > TOL["atol"])).any()
    torch.testing.assert_close(ds.pool_bwd_kernel(adj, sign_ref, g_pool), ds.pool_bwd_kernel_ref(adj, sign_ref, g_pool), **TOL)
    form = ds.form_name(dtype, torch.float32)
    assert ds.launches_by_dtype["diag_kernel"][form] == ds.launches["diag_kernel"] == 3
    assert ds.launches_by_dtype["pool_bwd_kernel"][form] == ds.launches["pool_bwd_kernel"] == 1


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_diag_kernels_raise_one_node_past_the_largest(cuda, dtype) -> None:
    n = ds.max_nodes(dtype) + 1
    adj = torch.zeros(1, n, n, dtype=dtype, device=cuda)
    x = torch.randn(4, n, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ds.diag_kernel(adj, x)


# several chunks with trailing capacity pads (F=16 and 38 in one 16- or
# 64-feature slice), one chunk at F=32 and F=70 (two slices), an empty
# graph, and the pooled regime
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    ("n", "chunk_tiles", "f"), [(2200, 3, 16), (2200, 3, 38), (1500, None, 32), (1500, None, 70), (0, None, 16), ("pooled", None, 32), ("pooled", None, 16)]
)
def test_weighted_bcsr_kernel_matches_plain_version(cuda, dtype, n, chunk_tiles, f) -> None:
    pairs, nodes = _bcsr_pairs(n)
    pairs = np.concatenate([pairs, pairs[:30], [[3, 3]]]) if n else pairs  # duplicate pairs and a self-loop
    weights = np.abs(np.random.default_rng(nodes).normal(size=len(pairs))).astype(np.float32) + 0.1
    st = bs.build_blocksparse(pairs, nodes, chunk_tiles=chunk_tiles, weights=weights, weight_dtype=dtype, device=cuda)
    assert st.blocks_t.dtype == dtype
    gen = torch.Generator(device=cuda).manual_seed(f)
    x = torch.randn(f, st.padded_nodes, generator=gen, device=cuda)
    cot = torch.randn(f, st.padded_rows, generator=gen, device=cuda)
    bs.reset_launches()
    out = bs.bcsr_spmm_kernel(st, x)
    torch.testing.assert_close(out, bs.bcsr_spmm_kernel_ref(st, x), **TOL)
    xk = x.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(bs.bcsr_spmm_t(st, xk), xk, cot)
    torch.testing.assert_close(grad, bs.bcsr_spmm_kernel_ref(st, cot), **TOL)
    assert bs.launches_by_dtype["bcsr_spmm_kernel"][bs.form_name(dtype, torch.float32)] == bs.launches["bcsr_spmm_kernel"] == 3
    if not n:
        assert not out.any()


# (model, layout, weighted adjacency)
SGAT_FOUTNET = {
    "sgat_diag": (SGATDiag, "diag", True),
    "foutnet_diag": (FoutNetDiag, "diag", False),
    "sgat_bcsr": (SGATBlockSparse, "bcsr", True),
    "foutnet_bcsr": (FoutNetBlockSparse, "bcsr", False),
}


@pytest.mark.parametrize("kind", sorted(SGAT_FOUTNET))
def test_sgat_and_foutnet_train_steps_match_cpu_and_count_launches(cuda, kind) -> None:
    cls, layout, weighted = SGAT_FOUTNET[kind]
    if layout == "diag":
        entries = ppi_clustered_entries(6, 40, 38, seed=2)
        entries[1]["y"] = None
        batch, _ = collate_graphs_diag_clustered(entries, pad_graphs=8, with_edge_weights=weighted, min_slot_nodes=1, device=cuda)
        kernels, module = "diag_kernel", ds
    else:
        entries = [clustered_entry(n, 38, seed=i) for i, n in enumerate((3000, 1300))]
        entries[1]["y"] = 0.0
        batch, _ = collate_graphs_blocksparse_clustered(entries, pad_graphs=3, with_edge_weights=weighted, slot8=True, device=cuda)
        kernels, module = "bcsr_spmm_kernel", bs
    model, cpu_model = cls(38, 2, 1, device=cuda), cls(38, 2, 1, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loss_fn = CrossEntropyLoss()
    for m in (bs, ds, sp):
        m.reset_launches()
    loss = loss_fn(model(batch), batch.y, batch.y_mask)
    loss.backward()
    # two aggregations forward and their two VJPs, on the adjacency's form
    form = "bfloat16/float32" if weighted else "int8/float32"
    assert module.launches_by_dtype[kernels] == {k: 4 if k == form else 0 for k in module.launches_by_dtype[kernels]}
    assert sp.launches == {"slot_fwd_kernel": 1, "slot_bwd_kernel": 1}
    assert sum(v for m in (bs, ds) for v in m.launches.values()) == 4
    cpu_batch = batch.to("cpu")
    cpu_loss = loss_fn(cpu_model(cpu_batch), cpu_batch.y, cpu_batch.y_mask)
    cpu_loss.backward()
    torch.testing.assert_close(loss.detach().cpu(), cpu_loss.detach(), rtol=1e-4, atol=1e-5)
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=1e-4, atol=1e-6, msg=name)


# ---------------------------------------------------------------------------
# The single-pass bf16 forms (compute_dtype=bfloat16): kernel and plain
# version round at the same points and sum in f32, so only the summation
# order differs (the f32 forms' tolerances); at the largest N of each
# (adjacency, activation) type pair.

BF16 = torch.bfloat16


@pytest.mark.parametrize("adj_dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize(("g", "n", "f"), [(5, 100, 16), (3, 64, 38), (2, 336, 32), (2, "max", 16)])
def test_bf16_diag_kernels_match_plain_versions(cuda, adj_dtype, g, n, f) -> None:
    if n == "max":
        n = ds.max_nodes(adj_dtype, cuda, BF16)
    if adj_dtype == torch.int8:
        adj, mask, _, _ = _operands(g, n, f, cuda, seed=n)
    else:
        adj, mask = _weighted_adjacency(g, n, adj_dtype, cuda, seed=n)
    gen = torch.Generator(device=cuda).manual_seed(f)
    x = torch.randn(f, g * n, generator=gen, device=cuda)
    g_pool = torch.randn(f, g, generator=gen, device=cuda)
    ds.reset_launches()
    torch.testing.assert_close(ds.diag_kernel(adj, x, compute_dtype=BF16), ds.diag_kernel_ref(adj, x, compute_dtype=BF16), **TOL)
    h = ds.diag_kernel_ref(adj, x, mask, "relu_mask", BF16)
    torch.testing.assert_close(ds.diag_kernel(adj, x.to(BF16), mask, "relu_mask", BF16), h, **TOL)
    sign, pooled = ds.diag_kernel(adj, x, mask, "relu_mask_pool", BF16)
    sign_ref, pooled_ref = ds.diag_kernel_ref(adj, x, mask, "relu_mask_pool", BF16)
    torch.testing.assert_close(pooled, pooled_ref, **TOL)
    assert not ((sign != sign_ref) & (h.abs() > TOL["atol"])).any()
    torch.testing.assert_close(ds.pool_bwd_kernel(adj, sign_ref, g_pool, BF16), ds.pool_bwd_kernel_ref(adj, sign_ref, g_pool, BF16), **TOL)
    form = ds.form_name(adj_dtype, BF16)
    assert ds.launches_by_dtype["diag_kernel"][form] == ds.launches["diag_kernel"] == 3
    assert ds.launches_by_dtype["pool_bwd_kernel"][form] == ds.launches["pool_bwd_kernel"] == 1


@pytest.mark.parametrize("adj_dtype", [torch.int8, torch.bfloat16])
def test_bf16_diag_kernels_raise_one_node_past_the_largest(cuda, adj_dtype) -> None:
    n = ds.max_nodes(adj_dtype, cuda, BF16) + 1
    adj = torch.zeros(1, n, n, dtype=adj_dtype, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ds.diag_kernel(adj, torch.randn(4, n, device=cuda), compute_dtype=BF16)


# ---------------------------------------------------------------------------
# The tensor-core body of K1 and K2 (int8 and bf16 adjacencies; the f32
# adjacency runs the FMA body beside it): N = 296 and 17 (not multiples of
# 16, N = 17 not of 4: scalar loads), F = 1 and 38 (a ragged feature chunk),
# in both forms.

TENSOR_CORE_SHAPES = [(64, 296, 32), (7, 296, 38), (5, 17, 1), (3, 17, 38)]


def _adjacency(dtype, g, n, dev, seed):
    if dtype == torch.int8:
        adj, mask, _, _ = _operands(g, n, 1, dev, seed=seed)
        return adj, mask
    return _weighted_adjacency(g, n, dtype, dev, seed=seed)


# every form: (adjacency type, compute_dtype)
DIAG_FORMS = [(torch.int8, None), (torch.bfloat16, None), (torch.float32, None), (torch.int8, BF16), (torch.bfloat16, BF16)]


@pytest.mark.parametrize(("adj_dtype", "compute_dtype"), DIAG_FORMS)
@pytest.mark.parametrize(("g", "n", "f"), TENSOR_CORE_SHAPES)
def test_diag_kernels_match_plain_versions_at_tensor_core_shapes(cuda, adj_dtype, compute_dtype, g, n, f) -> None:
    adj, mask = _adjacency(adj_dtype, g, n, cuda, seed=n + f)
    gen = torch.Generator(device=cuda).manual_seed(f)
    x = torch.randn(f, g * n, generator=gen, device=cuda)
    g_pool = torch.randn(f, g, generator=gen, device=cuda)
    cd = compute_dtype
    ds.reset_launches()
    torch.testing.assert_close(ds.diag_kernel(adj, x, compute_dtype=cd), ds.diag_kernel_ref(adj, x, compute_dtype=cd), **TOL)
    h = ds.diag_kernel_ref(adj, x, mask, "relu_mask", cd)
    torch.testing.assert_close(ds.diag_kernel(adj, x, mask, "relu_mask", cd), h, **TOL)
    sign, pooled = ds.diag_kernel(adj, x, mask, "relu_mask_pool", cd)
    sign_ref, pooled_ref = ds.diag_kernel_ref(adj, x, mask, "relu_mask_pool", cd)
    torch.testing.assert_close(pooled, pooled_ref, **TOL)
    assert not ((sign != sign_ref) & (h.abs() > TOL["atol"])).any()
    torch.testing.assert_close(ds.pool_bwd_kernel(adj, sign_ref, g_pool, cd), ds.pool_bwd_kernel_ref(adj, sign_ref, g_pool, cd), **TOL)
    form = ds.form_name(adj_dtype, ds.activation_dtype(cd))
    assert ds.launches_by_dtype["diag_kernel"][form] == ds.launches["diag_kernel"] == 3
    assert ds.launches_by_dtype["pool_bwd_kernel"][form] == ds.launches["pool_bwd_kernel"] == 1


# x from 1e-30 to 1e30: the three-piece split is exact at every magnitude, so
# each output is its plain version up to the order of its f32 sums; where
# they cancel, that order moves an output by a share of the sum of its terms'
# absolute values (atol 1e-6 x that sum, the gate of sums of many products)
@pytest.mark.parametrize("scale", [1e-30, 1e-10, 1e10, 1e30])
@pytest.mark.parametrize("compute_dtype", [None, BF16])
@pytest.mark.parametrize("adj_dtype", [torch.int8, torch.bfloat16])
def test_diag_kernels_match_plain_versions_across_magnitudes(cuda, adj_dtype, compute_dtype, scale) -> None:
    g, n, f = 16, 296, 38
    adj, mask = _adjacency(adj_dtype, g, n, cuda, seed=7)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(f, g * n, generator=gen, device=cuda) * scale
    g_pool = torch.randn(f, g, generator=gen, device=cuda) * scale
    cd = compute_dtype

    def close(got, want, terms):
        assert torch.isfinite(got).all()
        err = (got - want).abs()
        assert bool((err <= 1e-5 * want.abs() + 1e-6 * terms).all()), f"largest error {err.max().item():.3e} at scale {scale:g}"

    terms = ds.diag_kernel_ref(adj.abs(), x.abs(), compute_dtype=cd)
    close(ds.diag_kernel(adj, x, compute_dtype=cd), ds.diag_kernel_ref(adj, x, compute_dtype=cd), terms)
    h = ds.diag_kernel_ref(adj, x, mask, "relu_mask", cd)
    close(ds.diag_kernel(adj, x, mask, "relu_mask", cd), h, terms)
    sign, pooled = ds.diag_kernel(adj, x, mask, "relu_mask_pool", cd)
    sign_ref, pooled_ref = ds.diag_kernel_ref(adj, x, mask, "relu_mask_pool", cd)
    close(pooled, pooled_ref, terms.reshape(f, g, n).sum(2))
    assert not ((sign != sign_ref) & (h.abs() > 1e-6 * terms)).any()
    close(ds.pool_bwd_kernel(adj, sign_ref, g_pool, cd), ds.pool_bwd_kernel_ref(adj, sign_ref, g_pool, cd), ds.pool_bwd_kernel_ref(adj.abs(), sign_ref, g_pool.abs(), cd))


@contextlib.contextmanager
def _on_body(body):
    """Every K1/K2 launch in the block on ``body`` ("mma" or "fma"), whatever
    form ``ds.diag_body`` gives it."""
    with mock.patch.object(ds, "diag_body", lambda kernel, adj_dtype, act_dtype: body):
        yield


def _check_diag_forms(adj, mask, x, g_pool, compute_dtype) -> None:
    """K1 in its three modes and K2 against their plain versions at TOL."""
    cd = compute_dtype
    torch.testing.assert_close(ds.diag_kernel(adj, x, compute_dtype=cd), ds.diag_kernel_ref(adj, x, compute_dtype=cd), **TOL)
    h = ds.diag_kernel_ref(adj, x, mask, "relu_mask", cd)
    torch.testing.assert_close(ds.diag_kernel(adj, x, mask, "relu_mask", cd), h, **TOL)
    sign, pooled = ds.diag_kernel(adj, x, mask, "relu_mask_pool", cd)
    sign_ref, pooled_ref = ds.diag_kernel_ref(adj, x, mask, "relu_mask_pool", cd)
    torch.testing.assert_close(pooled, pooled_ref, **TOL)
    assert not ((sign != sign_ref) & (h.abs() > TOL["atol"])).any()
    torch.testing.assert_close(ds.pool_bwd_kernel(adj, sign_ref, g_pool, cd), ds.pool_bwd_kernel_ref(adj, sign_ref, g_pool, cd), **TOL)


# the other body of each form too (diag_body picks one by form; both run
# every form they take), and the tensor-core body refuses an f32 adjacency
@pytest.mark.parametrize("body", ["mma", "fma"])
@pytest.mark.parametrize(("adj_dtype", "compute_dtype"), DIAG_FORMS)
@pytest.mark.parametrize(("g", "n", "f"), [(7, 96, 38), (3, 17, 38)])
def test_diag_kernels_on_both_bodies_match_plain_versions(cuda, body, adj_dtype, compute_dtype, g, n, f) -> None:
    adj, mask = _adjacency(adj_dtype, g, n, cuda, seed=n + f)
    gen = torch.Generator(device=cuda).manual_seed(f)
    x = torch.randn(f, g * n, generator=gen, device=cuda)
    g_pool = torch.randn(f, g, generator=gen, device=cuda)
    with _on_body(body):
        if body == "mma" and adj_dtype == torch.float32:
            with pytest.raises(RuntimeError, match="CUDA error"):
                ds.diag_kernel(adj, x, compute_dtype=compute_dtype)
            return
        _check_diag_forms(adj, mask, x, g_pool, compute_dtype)


# K1's f32 form on an int8 adjacency runs on the tensor cores (diag_body
# names no other body for it, and nothing chooses one at run time) at the
# dense (N = 17, 96), clustered (296) and mixed (336) shapes: every mode
# against its plain version, counted on its form, and as near float64 as
# the FMA body that ran it before
@pytest.mark.parametrize("n", [17, 96, 296, 336])
def test_k1_int8_f32_form_runs_on_the_tensor_cores(cuda, n) -> None:
    assert ds.diag_body("diag_kernel", torch.int8, torch.float32) == "mma"
    g, f = 9, 38
    adj, mask = _adjacency(torch.int8, g, n, cuda, seed=n)
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(f, g * n, generator=gen, device=cuda)
    g_pool = torch.randn(f, g, generator=gen, device=cuda)
    ds.reset_launches()
    _check_diag_forms(adj, mask, x, g_pool, None)
    assert ds.launches_by_dtype["diag_kernel"]["int8/float32"] == ds.launches["diag_kernel"] == 3
    # both bodies against float64, within 16 f32 roundings of the sum of |terms|
    want = ds.diag_kernel_ref(adj, x.double())
    with _on_body("fma"):
        fma = ds.diag_kernel(adj, x).double()
    mma = ds.diag_kernel(adj, x).double()
    terms = ds.diag_kernel_ref(adj, x.abs().double())
    assert bool(((mma - want).abs() <= 2.0**-20 * terms).all()) and bool(((fma - want).abs() <= 2.0**-20 * terms).all())


def _signed_adjacency(g, n, dev, seed):
    """An int8 adjacency with entries in {-2, -1, 0, 1, 3}: a 0/1 graph whose
    edges in every other 32 x 32 block (the tensor-core body's warp steps)
    take a weight from {-2, -1, 1, 3}, so that some steps are all 0/1 and the
    others not."""
    adj, mask, _, _ = _operands(g, n, 1, "cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    weights = torch.tensor([-2, -1, 1, 3], dtype=torch.int8)[torch.randint(0, 4, adj.shape, generator=gen)]
    idx = torch.arange(n) // 32
    mixed = (idx[:, None] + idx[None, :]) % 2 == 0
    adj = torch.where(mixed & (adj != 0), weights, adj)
    assert set(adj.unique().tolist()) == {-2, -1, 0, 1, 3}
    return adj.to(dev), mask.to(dev)


# int8 entries past 0/1 (the tensor-core body's exponent trick for K1's bf16
# operands, and a K2 count that can be negative) in both forms and on both
# bodies, at N = 96 (16-byte loads) and N = 77 (scalar loads)
@pytest.mark.parametrize("body", ["mma", "fma"])
@pytest.mark.parametrize("compute_dtype", [None, BF16])
@pytest.mark.parametrize(("g", "n", "f"), [(6, 96, 38), (5, 77, 38)])
def test_diag_kernels_on_a_signed_int8_adjacency(cuda, body, compute_dtype, g, n, f) -> None:
    adj, mask = _signed_adjacency(g, n, cuda, seed=n)
    gen = torch.Generator(device=cuda).manual_seed(f)
    x = torch.randn(f, g * n, generator=gen, device=cuda)
    g_pool = torch.randn(f, g, generator=gen, device=cuda)
    ds.reset_launches()
    with _on_body(body):
        _check_diag_forms(adj, mask, x, g_pool, compute_dtype)
    sign, _ = ds.diag_kernel_ref(adj, x, mask, "relu_mask_pool", compute_dtype)
    counts = ds.diag_kernel_ref(adj, sign.float())
    assert (counts < 0).any() and (counts > 0).any()  # K2 met negative counts
    assert ds.launches["diag_kernel"] == 3 and ds.launches["pool_bwd_kernel"] == 1


# int8 blocks, and bf16 and f32 weighted ones (the bf16 form rounds f32
# blocks to bf16, as its plain version does); several chunks, two slices,
# empty, and the pooled regime
@pytest.mark.parametrize("block_dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize(("n", "chunk_tiles", "f"), [(2200, 3, 16), (1500, None, 70), (0, None, 32), ("pooled", None, 32), ("pooled", None, 16)])
def test_bf16_bcsr_kernel_matches_plain_version(cuda, block_dtype, n, chunk_tiles, f) -> None:
    pairs, nodes = _bcsr_pairs(n)
    if block_dtype == torch.int8:
        st = bs.build_blocksparse(pairs, nodes, chunk_tiles=chunk_tiles, device=cuda)
    else:
        weights = np.abs(np.random.default_rng(nodes).normal(size=len(pairs))).astype(np.float32) + 0.1
        st = bs.build_blocksparse(pairs, nodes, chunk_tiles=chunk_tiles, weights=weights, weight_dtype=block_dtype, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(f)
    x = torch.randn(f, st.padded_nodes, generator=gen, device=cuda)
    cot = torch.randn(f, st.padded_rows, generator=gen, device=cuda)
    bs.reset_launches()
    out = bs.bcsr_spmm_kernel(st, x, BF16)
    torch.testing.assert_close(out, bs.bcsr_spmm_kernel_ref(st, x, BF16), **TOL)
    xk = x.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(bs.bcsr_spmm_t(st, xk, BF16), xk, cot)
    torch.testing.assert_close(grad, bs.bcsr_spmm_kernel_ref(st, cot, BF16), **TOL)
    assert bs.launches_by_dtype["bcsr_spmm_kernel"][bs.form_name(block_dtype, BF16)] == bs.launches["bcsr_spmm_kernel"] == 3
    if not n:
        assert not out.any()


DW_TOL = 1e-6  # chip_smoke.py's share of sum |A||x| for sums of weighted products


def _signed_blocks(st, seed):
    """The structure with its int8 0/1 blocks reweighted in {-2, -1, 1, 3}
    (``signed_int8_blocks``: some blocks stay 0/1, the others are mixed)."""
    blocks = signed_int8_blocks(st.blocks_t.cpu().numpy(), st.tile_blocks.cpu().numpy(), seed)
    assert set(np.unique(blocks).tolist()) == {-2, -1, 0, 1, 3}
    return dataclasses.replace(st, blocks_t=torch.from_numpy(blocks).to(st.blocks_t.device))


# int8 entries past 0/1 in both forms, directly and through the VJP: several
# chunks, F=16 and 70, and the pooled regime
@pytest.mark.parametrize("compute_dtype", [None, BF16])
@pytest.mark.parametrize(("n", "chunk_tiles", "f"), [(2200, 3, 16), (1500, None, 70), ("pooled", None, 64)])
def test_bcsr_kernel_on_signed_int8_blocks(cuda, compute_dtype, n, chunk_tiles, f) -> None:
    pairs, nodes = _bcsr_pairs(n)
    st = _signed_blocks(bs.build_blocksparse(pairs, nodes, chunk_tiles=chunk_tiles, device=cuda), seed=f)
    st_abs = dataclasses.replace(st, blocks_t=st.blocks_t.abs())
    gen = torch.Generator(device=cuda).manual_seed(f)
    x = torch.randn(f, st.padded_nodes, generator=gen, device=cuda)
    cot = torch.randn(f, st.padded_rows, generator=gen, device=cuda)

    def tol(v):
        return {"rtol": 1e-5, "atol": max(1e-5, DW_TOL * bs.bcsr_spmm_kernel_ref(st_abs, v.abs(), compute_dtype).max().item())}

    bs.reset_launches()
    out = bs.bcsr_spmm_kernel(st, x, compute_dtype)
    want = bs.bcsr_spmm_kernel_ref(st, x, compute_dtype)
    torch.testing.assert_close(out, want, **tol(x))
    assert (want - bs.bcsr_spmm_kernel_ref(st_abs, x, compute_dtype)).abs().max() > 1.0  # the signs matter
    xk = x.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(bs.bcsr_spmm_t(st, xk, compute_dtype), xk, cot)
    torch.testing.assert_close(grad, bs.bcsr_spmm_kernel_ref(st, cot, compute_dtype), **tol(cot))
    form = bs.form_name(torch.int8, ds.activation_dtype(compute_dtype))
    assert bs.launches_by_dtype["bcsr_spmm_kernel"][form] == bs.launches["bcsr_spmm_kernel"] == 3


# 0/1 blocks: the kernel is the f32 loop in its order, bit for bit, in both
# forms: several chunks with an empty row tile, one chunk, F = 16, 19, 64, 70
@pytest.mark.parametrize("compute_dtype", [None, BF16])
@pytest.mark.parametrize(("n", "chunk_tiles", "f"), [(2200, 3, 16), (2200, 3, 19), (1500, None, 64), (1500, None, 70), ("pooled", None, 64)])
def test_bcsr_kernel_is_its_order_loop_bit_for_bit(cuda, compute_dtype, n, chunk_tiles, f) -> None:
    pairs, nodes = _bcsr_pairs(n)
    if n != "pooled":  # no edge into the second row tile
        pairs = pairs[((pairs // 128) != 1).all(axis=1)]
    st = bs.build_blocksparse(pairs, nodes, chunk_tiles=chunk_tiles, device=cuda)
    counts = st.tile_ptr[1:] - st.tile_ptr[:-1]
    assert n == "pooled" or (counts == 0).any()
    x = torch.randn(f, st.padded_nodes, generator=torch.Generator(device=cuda).manual_seed(f), device=cuda)
    out = bs.bcsr_spmm_kernel(st, x, compute_dtype)
    torch.testing.assert_close(out, bs.bcsr_spmm_order_ref(st, x, compute_dtype), rtol=0, atol=0)
    assert not out.reshape(f, -1, 128)[:, counts == 0].any()


@pytest.mark.parametrize("m", BLOCKED_M)
@pytest.mark.parametrize("case", ["ragged", "pads", "no_edges"])
def test_bf16_blocked_kernels_match_plain_versions(cuda, case, m) -> None:
    st = _blocked_structure(case, cuda)
    gen = torch.Generator(device=cuda).manual_seed(m)
    xr, xc, g = (torch.randn(st.padded_nodes, m, generator=gen, device=cuda) for _ in range(3))
    w_e = torch.randn(st.edge_dim, m, generator=gen, device=cuda)
    vn.reset_launches()
    out = vn.blocked_fwd_kernel(st, xr, xc, w_e, BF16)
    torch.testing.assert_close(out, vn.blocked_fwd_kernel_ref(st, xr, xc, w_e, BF16), **TOL)
    dxr, dxc, dw_e = vn.blocked_bwd_kernel(st, xr, xc, w_e, g, BF16)
    want = vn.blocked_bwd_kernel_ref(st, xr, xc, w_e, g, BF16)
    torch.testing.assert_close(dxr, want[0], **TOL)
    torch.testing.assert_close(dxc, want[1], **TOL)
    torch.testing.assert_close(dw_e, want[2], rtol=1e-5, atol=1e-6 * vn.dw_error_scale(st, g, BF16).max().item() + 1e-6)
    _assert_blocked_order(st, xr, xc, w_e, g, out, dxr, dxc, BF16)
    assert vn.launches_by_dtype == {"blocked_fwd_kernel": {"float32": 0, "bfloat16": 1}, "blocked_bwd_kernel": {"float32": 0, "bfloat16": 1}}
    args = [t.clone().requires_grad_(True) for t in (xr, xc, w_e)]
    grads = torch.autograd.grad(be.blocked_message_sum(st, *args, compute_dtype=BF16), args, g)
    for got, ref in zip(grads, (dxr, dxc, dw_e)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)  # deterministic: no atomics
    if case == "no_edges":
        assert not out.any() and not dxr.any() and not dxc.any() and not dw_e.any()


def _bf16_batch(kind, dev):
    if kind == "dense":
        return collate_graphs_dense(synthetic_entries(6, 40, 38, 6, seed=2), pad_graphs=8, pad_nodes=64, device=dev)[0], GINetDense, 6
    if kind == "clustered_diag":
        return collate_graphs_diag_clustered(ppi_clustered_entries(6, 40, 38, seed=2), pad_graphs=8, min_slot_nodes=1, device=dev)[0], GINetClusteredDiag, 1
    if kind == "bcsr":
        return collate_graphs_blocksparse([geometric_entry(n, 38, 1, seed=i) for i, n in enumerate((700, 1300))], pad_graphs=3, device=dev)[0], GINetBlockSparse, 1
    if kind == "clustered_bcsr":
        entries = [clustered_entry(n, 38, seed=i) for i, n in enumerate((3000, 1300))]
        return collate_graphs_blocksparse_clustered(entries, pad_graphs=3, slot8=True, device=dev)[0], GINetClusteredBlockSparse, 1
    return collate_graphs_blocked([geometric_entry(n, 38, 6, seed=i) for i, n in enumerate((700, 1300))], pad_graphs=3, device=dev)[0], VanillaNetworkBlocked, 6


# kind: {kernel[form]: launches in one forward and backward}
BF16_FORMS = {
    "dense": {"diag_kernel[int8/bfloat16]": 3, "pool_bwd_kernel[int8/bfloat16]": 1},
    "clustered_diag": {"diag_kernel[int8/bfloat16]": 4},
    "bcsr": {"bcsr_spmm_kernel[int8/bfloat16]": 4},
    "clustered_bcsr": {"bcsr_spmm_kernel[int8/bfloat16]": 4},
    "blocked": {"blocked_fwd_kernel[bfloat16]": 2, "blocked_bwd_kernel[bfloat16]": 2},
}


@pytest.mark.parametrize("kind", sorted(BF16_FORMS))
def test_bf16_train_steps_match_cpu_and_count_launches(cuda, kind) -> None:
    """The card and the CPU run the same bf16 forms, but round values that
    they sum in different orders (the f32 weight products, GINetDense's bf16
    GEMMs), so a value can land on the neighbouring bf16 number: atol is one
    bf16 step at each tensor's largest magnitude (2^-7 of it: a bf16 holds 8
    significant bits)."""
    batch, cls, fe = _bf16_batch(kind, cuda)
    model, cpu_model = cls(38, 2, fe, device=cuda, compute_dtype=BF16), cls(38, 2, fe, device="cpu", compute_dtype=BF16)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loss_fn = CrossEntropyLoss()
    modules = (bs, ds, vn)
    for m in (*modules, sp):
        m.reset_launches()
    loss = loss_fn(model(batch), batch.y, batch.y_mask)
    loss.backward()
    forms = {f"{k}[{form}]": n for m in modules for k, by_form in m.launches_by_dtype.items() for form, n in by_form.items() if n}
    assert forms == BF16_FORMS[kind]
    cpu_batch = batch.to("cpu")
    cpu_loss = loss_fn(cpu_model(cpu_batch), cpu_batch.y, cpu_batch.y_mask)
    cpu_loss.backward()
    torch.testing.assert_close(loss.detach().cpu(), cpu_loss.detach(), rtol=1e-4, atol=2.0**-7 * cpu_loss.abs().item())
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        if q.grad is None:
            assert p.grad is None, name
        else:
            torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=1e-4, atol=2.0**-7 * q.grad.abs().max().item() + 1e-12, msg=name)


# ---------------------------------------------------------------------------
# The bf16 forms of the fused towers (K8f, K8b, K9f, K9b). Kernel and plain
# version round at the same points, but a value about to be rounded that the
# two sum in other orders can land on the neighbouring bf16 number (a flip),
# which moves what follows by at most one bf16 step of that value. So each
# output is held to the f32-order bound (rtol 1e-5, atol 1e-6 × Σ|terms|,
# the same value on the absolute operands) except at most 0.1 % of its
# entries, each within 2^-7 × (Σ|terms| + |value|); K9f's sign may differ
# only where |h2| is within 2^-7 × Σ|terms| of zero.

FLIP = 2.0**-7


def _flip_close(got, want, scale, what) -> None:
    got, want, scale = (t.detach().double().cpu() for t in (got, want, scale))
    err = (got - want).abs()
    off = err > 1e-5 * want.abs() + 1e-6 * scale
    assert off.double().mean().item() <= 1e-3, f"{what}: {int(off.sum())} of {off.numel()} entries off the f32-order bound"
    assert (err[off] <= FLIP * (scale + want.abs())[off]).all(), what


@pytest.mark.parametrize(("g", "n", "f", "c1", "c2"), [(512, 160, 38, 32, 64), (7, 96, 38, 32, 64), (3, 251, 38, 32, 64), (5, 40, 5, 6, 10)])
def test_bf16_tower_kernels_match_plain_versions(cuda, g, n, f, c1, c2) -> None:
    adj, mask, x, x_t, w1, w2, dp = _tower_operands(g, n, f, c1, c2, cuda)
    gt.reset_launches()
    ds.reset_launches()
    args = (w1, w2, x, adj, mask)
    abs_args = (w1.abs(), w2.abs(), x.abs(), adj, mask)
    _flip_close(gt.ginet_tower_fwd_kernel(*args, BF16), gt.ginet_tower_fwd_kernel_ref(*args, BF16), gt.ginet_tower_fwd_kernel_ref(*abs_args, BF16), "K8f")
    got, want = gt.ginet_tower_bwd_kernel(*args, dp, BF16), gt.ginet_tower_bwd_kernel_ref(*args, dp, BF16)
    for what, a, b, scale in zip(("dw1", "dw2"), got, want, gt.dw_error_scale(*args, dp, BF16)):
        _flip_close(a, b, scale, f"K8b {what}")
    assert gt.launches_by_dtype == {k: {"int8/float32": 0, "int8/bfloat16": 1} for k in gt.launches}
    fargs = (adj, x_t, mask, w1, w2)
    h1, sign, pooled = ds.tower_fwd_kernel(*fargs, BF16)
    h1_r, sign_r, pooled_r = ds.tower_fwd_kernel_ref(*fargs, BF16)
    h1_s, _, pooled_s = ds.tower_fwd_kernel_ref(adj, x_t.abs(), mask, w1.abs(), w2.abs(), BF16)
    _flip_close(h1, h1_r, h1_s, "K9f h1")
    _flip_close(pooled, pooled_r, pooled_s, "K9f pooled")
    rw2 = ds.round_to(w2, BF16)
    h2 = torch.relu(ds.diag_kernel_ref(adj, rw2.T @ ds.round_to(h1_r, BF16), compute_dtype=BF16)) * mask.reshape(1, -1)
    h2_s = ds.diag_kernel_ref(adj, rw2.abs().T @ ds.round_to(h1_s, BF16), compute_dtype=BF16)
    differ = sign != sign_r
    assert differ.double().mean().item() <= 1e-3 and (h2[differ] <= FLIP * h2_s[differ]).all()
    bwd = (adj, dp.T.contiguous(), sign_r, h1_r, w2)
    got, want = ds.tower_bwd_kernel(*bwd, BF16), ds.tower_bwd_kernel_ref(*bwd, BF16)
    for what, a, b, scale in zip(("t2", "t1"), got, want, ds.tower_bwd_error_scale(*bwd, BF16)):
        assert a.dtype == b.dtype == BF16
        _flip_close(a.float(), b.float(), scale, f"K9b {what}")
    forms = {k: ds.launches_by_dtype[k] for k in ("tower_fwd_kernel", "tower_bwd_kernel")}
    assert forms == {k: {"int8/float32": 0, "int8/bfloat16": 1} for k in forms}


def _ragged_tower_operands(g, n, f, c1, c2, dev, seed=0):
    """As _tower_operands, for any N >= 1: graph i keeps its first n - (3 i)
    mod (n // 2 + 1) nodes."""
    gen = torch.Generator().manual_seed(seed)
    adj = torch.rand(g, n, n, generator=gen) < 0.05
    adj = adj | adj.transpose(1, 2)
    mask = torch.ones(g, n, dtype=torch.bool)
    for i in range(g):
        mask[i, n - (3 * i) % (n // 2 + 1) :] = False
    adj &= mask[:, :, None] & mask[:, None, :]
    x = torch.randn(g, n, f, generator=gen)
    w1, w2 = torch.randn(f, c1, generator=gen) * 0.2, torch.randn(c1, c2, generator=gen) * 0.2
    dpooled = torch.randn(g, c2, generator=gen)
    return [t.to(dev) for t in (adj.to(torch.int8), mask, x, w1, w2, dpooled)]


# K8b in both forms at N = 1, 17 (padded to the 16-node tiles), 160 and the
# largest N supports() admits at these widths (384, the backward plan's own
# limit), C1 = 20 and C2 = 36 (padded to 32 and 48); ragged masks. The f32
# form at the f32-order bound (dw_error_scale), the bf16 form at _flip_close;
# two calls give the same bits (no atomics).
@pytest.mark.parametrize("compute_dtype", [None, BF16])
@pytest.mark.parametrize(("g", "n"), [(9, 1), (9, 17), (12, 160), (3, "max")])
def test_tower_bwd_kernel_in_both_forms_matches_plain_version(cuda, compute_dtype, g, n) -> None:
    f, c1, c2 = 38, 20, 36
    if n == "max":
        n = max(k for k in range(1, 1025) if gt.supports(1, k, f, c1, c2))
        assert n == 384 and gt.bwd_smem_bytes(n + 1, f, c1, c2) > gt.SMEM_LIMIT
    adj, mask, x, w1, w2, dp = _ragged_tower_operands(g, n, f, c1, c2, cuda)
    args = (w1, w2, x, adj, mask, dp, compute_dtype)
    gt.reset_launches()
    got, again = gt.ginet_tower_bwd_kernel(*args), gt.ginet_tower_bwd_kernel(*args)
    assert gt.launches["ginet_tower_bwd_kernel"] == 2
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for what, a, b, scale in zip(("dw1", "dw2"), got, gt.ginet_tower_bwd_kernel_ref(*args), gt.dw_error_scale(*args)):
        if compute_dtype is None:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * scale.max().item(), msg=what)
        else:
            _flip_close(a, b, scale, f"K8b {what}")


def test_dense_tower_bf16_train_step_matches_cpu_and_counts_launches(cuda) -> None:
    """GINetDense(compute_dtype=bf16) on the "pallas" backend: only the bf16
    tower forms run, and the step agrees with the CPU's (the same forms'
    plain versions) at rtol 1e-4 and one bf16 step at each tensor's largest
    magnitude (a value rounded after sums in other orders can flip)."""
    entries = synthetic_entries(6, 40, 38, 6, seed=2)
    batch, _ = collate_graphs_dense(entries, pad_graphs=7, pad_nodes=64, device=cuda)
    model, cpu_model = GINetDense(38, 2, 6, device=cuda, compute_dtype=BF16), GINetDense(38, 2, 6, device="cpu", compute_dtype=BF16)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loss_fn = CrossEntropyLoss()
    set_dense_tower_backend("pallas")
    try:
        ds.reset_launches()
        gt.reset_launches()
        loss = loss_fn(model(batch), batch.y, batch.y_mask)
        loss.backward()
        assert gt.launches_by_dtype == {k: {"int8/float32": 0, "int8/bfloat16": 1} for k in gt.launches}
        assert not any(ds.launches.values())
        cpu_batch = batch.to("cpu")
        cpu_loss = loss_fn(cpu_model(cpu_batch), cpu_batch.y, cpu_batch.y_mask)
        cpu_loss.backward()
    finally:
        set_dense_tower_backend("xla")
    torch.testing.assert_close(loss.detach().cpu(), cpu_loss.detach(), rtol=1e-4, atol=FLIP * cpu_loss.abs().item())
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        if q.grad is None:
            assert p.grad is None, name
        else:
            torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=1e-4, atol=FLIP * q.grad.abs().max().item() + 1e-12, msg=name)


def test_sgat_diag_bf16_on_an_f32_adjacency_matches_cpu(cuda) -> None:
    """SGATDiag under bf16 on the f32 adjacency of weight_dtype=float32: JAX's
    XLA fallback (the adjacency and x rounded to bf16, f32 sums, the
    aggregate rounded to bf16), run as K1's bf16 form on the rounded
    adjacency: two aggregations and their VJPs of the bfloat16/bfloat16
    form. Against the CPU at the bf16 steps' tolerance."""
    entries = ppi_clustered_entries(6, 40, 38, seed=2)
    batch, _ = collate_graphs_diag_clustered(entries, pad_graphs=8, with_edge_weights=True, weight_dtype=torch.float32, min_slot_nodes=1, device=cuda)
    assert batch.adj_w.dtype == torch.float32
    model, cpu_model = SGATDiag(38, 2, 1, device=cuda, compute_dtype=BF16), SGATDiag(38, 2, 1, device="cpu", compute_dtype=BF16)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    loss_fn = CrossEntropyLoss()
    ds.reset_launches()
    loss = loss_fn(model(batch), batch.y, batch.y_mask)
    loss.backward()
    assert {k: n for k, n in ds.launches_by_dtype["diag_kernel"].items() if n} == {"bfloat16/bfloat16": 4}
    cpu_batch = batch.to("cpu")
    cpu_loss = loss_fn(cpu_model(cpu_batch), cpu_batch.y, cpu_batch.y_mask)
    cpu_loss.backward()
    torch.testing.assert_close(loss.detach().cpu(), cpu_loss.detach(), rtol=1e-4, atol=FLIP * cpu_loss.abs().item())
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=1e-4, atol=FLIP * q.grad.abs().max().item() + 1e-12, msg=name)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


# K8f and K9b in both forms at N = 1, 33 (off the 16-node tiles and the
# 32-node bit words), 160 and each kernel's largest N (its own plan's end:
# K8f 400, K9b 457), at G = 1 and at G = 300
# (more graphs than the blocks resident at once), ragged masks. Two calls
# give the same bits, and a graph computed alone gives the same bits as
# inside the batch. The f32 forms at the f32-order bounds, the bf16 forms at
# _flip_close; K9b's t2 is g_pool times the count rounded once (f32: bit for
# bit; bf16: its plain version's values exactly, a count times a bf16 value
# being exact), and an all-zero sign or a zero g_pool gives zeros.
@pytest.mark.parametrize("compute_dtype", [None, BF16])
@pytest.mark.parametrize("n", [1, 33, 160, "max"])
@pytest.mark.parametrize("g", [1, 300])
def test_ginet_tower_fwd_kernel_in_both_forms_matches_plain_version(cuda, compute_dtype, n, g) -> None:
    f, c1, c2 = 38, 32, 64
    if n == "max":
        n = max(k for k in range(1, 1025) if gt.smem_bytes(k, f, c1, c2) <= gt.SMEM_LIMIT)
        assert n == 400
    adj, mask, x, w1, w2, _ = _ragged_tower_operands(g, n, f, c1, c2, cuda, seed=n)
    args = (w1, w2, x, adj, mask)
    gt.reset_launches()
    got, again = gt.ginet_tower_fwd_kernel(*args, compute_dtype), gt.ginet_tower_fwd_kernel(*args, compute_dtype)
    k = g // 2
    alone = gt.ginet_tower_fwd_kernel(w1, w2, x[k : k + 1].contiguous(), adj[k : k + 1].contiguous(), mask[k : k + 1].contiguous(), compute_dtype)
    assert gt.launches["ginet_tower_fwd_kernel"] == 3
    assert torch.equal(_bits(got), _bits(again))
    assert torch.equal(_bits(alone), _bits(got[k : k + 1]))
    want = gt.ginet_tower_fwd_kernel_ref(*args, compute_dtype)
    if compute_dtype is None:
        torch.testing.assert_close(got, want, **TOL)
    else:
        _flip_close(got, want, gt.ginet_tower_fwd_kernel_ref(w1.abs(), w2.abs(), x.abs(), adj, mask, compute_dtype), "K8f")


# K9f in both forms on the towers' plan at N = 17, 96, 160 and its largest N
# (the forward plan's end, 400), at G = 1 and 300, ragged masks: h1 and the
# sign of h2 bit for bit against the kernel's order as a loop
# (tower_fwd_order_ref); h1 and pooled against the plain version (f32 order,
# or _flip_close in bf16), the sign wherever h2 is clear of zero; two calls
# the same bits, a graph alone the same bits as in the batch.
@pytest.mark.parametrize("compute_dtype", [None, BF16])
@pytest.mark.parametrize("n", [17, 96, 160, "max"])
@pytest.mark.parametrize("g", [1, 300])
def test_tower_fwd_kernel_in_both_forms_on_the_towers_plan(cuda, compute_dtype, n, g) -> None:
    f, c1, c2 = 38, 32, 64
    if n == "max":
        n = max(k for k in range(1, 1025) if ds.tower_supports(1, k, f, c1, c2))
        assert n == 400 == max(k for k in range(1, 1025) if ds.tower_fwd_smem_bytes(k, f, c1, c2) <= ds.SMEM_LIMIT)
    adj, mask, x, w1, w2, _ = _ragged_tower_operands(g, n, f, c1, c2, cuda, seed=n + 1)
    x_t = x.reshape(g * n, f).T.contiguous()
    fargs = (adj, x_t, mask, w1, w2)
    ds.reset_launches()
    got, again = ds.tower_fwd_kernel(*fargs, compute_dtype), ds.tower_fwd_kernel(*fargs, compute_dtype)
    k = g // 2
    cols = slice(k * n, (k + 1) * n)
    alone = ds.tower_fwd_kernel(adj[k : k + 1].contiguous(), x_t[:, cols].contiguous(), mask[k : k + 1].contiguous(), w1, w2, compute_dtype)
    assert ds.launches["tower_fwd_kernel"] == 3
    form = ds.form_name(torch.int8, ds.activation_dtype(compute_dtype))
    assert ds.launches_by_dtype["tower_fwd_kernel"][form] == 3
    for a, b, c in zip(got, again, alone):
        assert torch.equal(_bits(a) if a.is_floating_point() else a, _bits(b) if b.is_floating_point() else b)
    assert torch.equal(_bits(alone[0]), _bits(got[0][:, cols])) and torch.equal(alone[1], got[1][:, cols])
    assert torch.equal(_bits(alone[2]), _bits(got[2][:, k : k + 1]))
    h1, sign, pooled = got
    h1_o, sign_o = ds.tower_fwd_order_ref(*fargs, compute_dtype)
    assert torch.equal(_bits(h1), _bits(h1_o)) and torch.equal(sign, sign_o)
    h1_r, sign_r, pooled_r = ds.tower_fwd_kernel_ref(*fargs, compute_dtype)
    act = ds.activation_dtype(compute_dtype)
    h2 = torch.relu(ds.diag_kernel_ref(adj, ds.round_to(w2, act).T @ ds.round_to(h1_r, act))) * mask.reshape(1, -1)
    if compute_dtype is None:
        torch.testing.assert_close(h1, h1_r, **TOL)
        torch.testing.assert_close(pooled, pooled_r, **TOL)
        assert not ((sign != sign_r) & (h2.abs() > 1e-6 * h2.abs().max())).any()
    else:
        h1_s, _, pooled_s = ds.tower_fwd_kernel_ref(adj, x_t.abs(), mask, w1.abs(), w2.abs(), compute_dtype)
        _flip_close(h1, h1_r, h1_s, "K9f h1")
        _flip_close(pooled, pooled_r, pooled_s, "K9f pooled")


@pytest.mark.parametrize("compute_dtype", [None, BF16])
@pytest.mark.parametrize("n", [1, 33, 160, "max"])
@pytest.mark.parametrize("g", [1, 300])
def test_tower_bwd_kernel_in_both_forms_on_its_plan_matches_plain_version(cuda, compute_dtype, n, g) -> None:
    f, c1, c2 = 38, 32, 64
    if n == "max":
        n = max(k for k in range(1, 1025) if ds.tower_bwd_smem_bytes(k, c1, c2) <= ds.SMEM_LIMIT)
        assert n == 457
    adj, mask, x, w1, w2, dp = _ragged_tower_operands(g, n, f, c1, c2, cuda, seed=n)
    x_t = x.reshape(g * n, f).T.contiguous()
    h1, sign, _ = ds.tower_fwd_kernel_ref(adj, x_t, mask, w1, w2, compute_dtype)
    g_pool = dp.T.contiguous()
    k = g // 2
    cols = slice(k * n, (k + 1) * n)
    for case, s, gp in (("signs", sign, g_pool), ("no sign set", torch.zeros_like(sign), g_pool), ("zero g_pool", sign, torch.zeros_like(g_pool))):
        bwd = (adj, gp, s, h1, w2)
        ds.reset_launches()
        got, again = ds.tower_bwd_kernel(*bwd, compute_dtype), ds.tower_bwd_kernel(*bwd, compute_dtype)
        alone = ds.tower_bwd_kernel(adj[k : k + 1].contiguous(), gp[:, k : k + 1].contiguous(), s[:, cols].contiguous(), h1[:, cols].contiguous(), w2, compute_dtype)
        assert ds.launches["tower_bwd_kernel"] == 3
        want = ds.tower_bwd_kernel_ref(*bwd, compute_dtype)
        for what, a, b, c, w, scale in zip(("t2", "t1"), got, again, alone, want, ds.tower_bwd_error_scale(*bwd, compute_dtype)):
            assert a.dtype == w.dtype == (compute_dtype or torch.float32), (case, what)
            assert torch.equal(_bits(a), _bits(b)), (case, what)
            assert torch.equal(_bits(c), _bits(a[:, cols])), (case, what)
            if case != "signs":
                assert not a.any(), (case, what)
            elif compute_dtype is None:
                torch.testing.assert_close(a, w, rtol=1e-5, atol=max(1e-5, 1e-6 * scale.max().item()), msg=f"K9b {what}")
                if what == "t2":  # g_pool times the count, rounded once
                    assert torch.equal(_bits(a), _bits(gp.repeat_interleave(n, dim=1) * ds.diag_kernel_ref(adj, s.float()) + 0.0))
            elif what == "t2":
                assert torch.equal(a, w)  # the same values (a zero's sign aside)
            else:
                _flip_close(a.float(), w.float(), scale, f"K9b {what}")


# ---------------------------------------------------------------------------
# The Trainer's block-sparse, clustered block-sparse and blocked-edge
# branches, the batched dense family, their padded shapes, and GINetDense's
# batched branch beyond K1's shared memory.


def _chip_smoke():
    """chip_smoke.py's in-memory Trainer (this machine may have no h5py)."""
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def _small_entries(kind):
    if kind in ("bcsr", "blocked"):
        entries = [geometric_entry(n, 38, 6, seed=i) for i, n in enumerate((900, 1500, 400))]
    elif kind == "clustered_bcsr":
        entries = [clustered_entry(n, 38, 1, seed=i) for i, n in enumerate((1500, 2500, 700))]
    else:
        entries = ppi_clustered_entries(12, 40, 38, seed=3)
    for i, e in enumerate(entries):
        e["entry_name"], e["y"] = f"e{i}", float(i % 2)
    return entries


# model -> (entries, {kernel[form]: launches a train step}, gradient atol)
TRAINER_BRANCHES = {
    GINetBlockSparse: ("bcsr", {"bcsr_spmm_kernel[int8/float32]": 4}, 1e-6),
    GINetClusteredBlockSparse: ("clustered_bcsr", {"bcsr_spmm_kernel[int8/float32]": 4}, 1e-6),
    SGATBlockSparse: ("clustered_bcsr", {"bcsr_spmm_kernel[bfloat16/float32]": 4}, 1e-5),
    FoutNetBlockSparse: ("clustered_bcsr", {"bcsr_spmm_kernel[int8/float32]": 4}, 1e-5),
    VanillaNetworkBlocked: ("blocked", {"blocked_fwd_kernel[float32]": 2, "blocked_bwd_kernel[float32]": 2}, 1e-6),
}


@pytest.mark.parametrize("model", [*TRAINER_BRANCHES, "GINetClusteredDense", "FoutNetDense", "SGATDense"], ids=lambda m: m if isinstance(m, str) else m.__name__)
def test_trainer_branch_epoch_matches_cpu(cuda, model) -> None:
    """One dropout-free epoch through ``Trainer.train`` (one graph a batch for
    the atomic layouts, the grow-only buckets growing), card against CPU
    from the same weights: every pass's loss at rtol 1e-4, atol 1e-5, the
    last step's gradients at rtol 1e-4 and the bare step's atol, the
    launches a step by form, and the same buckets. The optimizer is SGD:
    Adam's steps move a parameter by about lr times the sign of its
    gradient, so a gradient that rounding alone makes nonzero would move
    the two sides apart by lr over the steps before the last."""
    from deeprank2_tpu_torch.neuralnets.gnn import foutnet, ginet_dense, sgat
    from deeprank2_tpu_torch.ops import optim

    cs = _chip_smoke()
    if isinstance(model, str):
        model = {"GINetClusteredDense": ginet_dense.GINetClusteredDense, "FoutNetDense": foutnet.FoutNetDense, "SGATDense": sgat.SGATDense}[model]
        kind, step_forms, grad_atol, batch_size = "dense", {}, 1e-5, 6
    else:
        (kind, step_forms, grad_atol), batch_size = TRAINER_BRANCHES[model], 1
    entries = _small_entries(kind)
    clustered = getattr(model, "needs_clusters", False)
    no_dropout = type(model.__name__, (model,), {"dropout": 0.0})
    recs = {side: cs.Recorder() for side in ("card", "cpu")}
    trainers = {side: cs.in_memory_trainer(no_dropout, entries, clustered, output_exporters=[recs[side]], device=dev) for side, dev in (("card", cuda), ("cpu", "cpu"))}
    trainers["cpu"].model.load_state_dict({k: v.cpu() for k, v in trainers["card"].model.state_dict().items()})
    for t in trainers.values():
        t.configure_optimizers(optim.SGD, lr=1e-3)
    modules = (bs, ds, vn, sp)
    for side, t in trainers.items():
        for m in modules:
            m.reset_launches()
        t.train(nepoch=1, batch_size=batch_size, shuffle=False, filename=None)
        if side == "card":
            torch.cuda.synchronize()
            forms = {f"{k}[{form}]": n for m in modules for k, by_form in getattr(m, "launches_by_dtype", {}).items() for form, n in by_form.items() if n}
    steps = -(-len(entries) // batch_size)
    # an eval forward: K5 twice (a step also runs the two VJPs), K6f twice (a step adds K6b twice)
    eval_forms = {k: n // 2 if k.startswith("bcsr") else n if k.startswith("blocked_fwd") else 0 for k, n in step_forms.items()}
    assert forms == {k: n * steps + eval_forms[k] * steps for k, n in step_forms.items()}
    losses = {side: torch.tensor([p["loss"] for p in r.passes]) for side, r in recs.items()}
    torch.testing.assert_close(losses["card"], losses["cpu"], rtol=1e-4, atol=1e-5)
    for (name, p), q in zip(trainers["card"].model.named_parameters(), trainers["cpu"].model.parameters()):
        assert (p.grad is None) == (q.grad is None), name
        if q.grad is not None:
            torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=1e-4, atol=grad_atol, msg=name)
    assert getattr(trainers["card"], "_bs_caps", None) == getattr(trainers["cpu"], "_bs_caps", None)


def test_kernels_match_plain_versions_at_bucketed_padded_shapes(cuda) -> None:
    """K5 (int8 and bf16 blocks, both forms), K3/K4 and K6f/K6b at shapes
    padded by capacity buckets: padding tiles, blocks, slabs and member
    slots present."""
    pads = {"pad_tiles": lambda r: r + 9, "pad_blocks": lambda r: r + 300}
    b_batch, _ = collate_graphs_blocksparse(_small_entries("bcsr"), device=cuda, **pads)
    cpads = {**pads, "pad_pooled_tiles": lambda r: r + 2, "pad_pooled_blocks": lambda r: r + 50, "pad_c1": lambda r: r + 5, "pad_members0s": lambda r: r + 2}
    clustered = [collate_graphs_blocksparse_clustered(_small_entries("clustered_bcsr"), slot8=True, with_edge_weights=w, device=cuda, **cpads)[0] for w in (False, True)]
    bl_batch, _ = collate_graphs_blocked(_small_entries("blocked"), pad_tiles=lambda r: r + 4, pad_slabs=lambda r: r + 7, device=cuda)
    for cd in (None, BF16):
        for st in (b_batch.structure, *(s for c in clustered for s in (c.structure, c.structure_p))):
            assert st.num_blocks > st.tile_blocks.numel()
            x = torch.randn(16, st.padded_nodes, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
            want = bs.bcsr_spmm_kernel_ref(st, x, cd)
            atol = 1e-5 if st.blocks_t.dtype == torch.int8 else max(1e-5, 1e-6 * bs.bcsr_spmm_kernel_ref(st, x.abs(), cd).abs().max().item())
            torch.testing.assert_close(bs.bcsr_spmm_kernel(st, x, cd), want, rtol=1e-5, atol=atol)
            if st.blocks_t.dtype == torch.int8:
                torch.testing.assert_close(bs.bcsr_spmm_kernel(st, x, cd), bs.bcsr_spmm_order_ref(st, x, cd), rtol=0, atol=0)
    mask = clustered[0].node_mask.float().reshape(1, -1)
    h = torch.rand(16, mask.shape[1], generator=torch.Generator(device=cuda).manual_seed(2), device=cuda) * mask
    pooled = sp.slot_fwd_kernel(h, 8)
    torch.testing.assert_close(pooled, sp.slot_fwd_kernel_ref(h, 8), rtol=0, atol=0)
    g = torch.randn_like(pooled)
    torch.testing.assert_close(sp.slot_bwd_kernel(h, mask, pooled, g, 8), sp.slot_bwd_kernel_ref(h, mask, pooled, g, 8), rtol=0, atol=0)
    st = bl_batch.structure
    gen = torch.Generator(device=cuda).manual_seed(3)
    xr, xc, g = (torch.randn(st.padded_nodes, 12, generator=gen, device=cuda) for _ in range(3))
    w_e = torch.randn(st.edge_dim, 12, generator=gen, device=cuda)
    torch.testing.assert_close(vn.blocked_fwd_kernel(st, xr, xc, w_e), vn.blocked_fwd_kernel_ref(st, xr, xc, w_e), **TOL)
    for got, want in zip(vn.blocked_bwd_kernel(st, xr, xc, w_e, g)[:2], vn.blocked_bwd_kernel_ref(st, xr, xc, w_e, g)[:2]):
        torch.testing.assert_close(got, want, **TOL)


def test_ginet_dense_beyond_k1_max_nodes_takes_the_batched_branch(cuda) -> None:
    """N one tile of 32 past K1's shared memory: no kernel launches, and one
    step equals the CPU's batched branch at the dense step's tolerances."""
    n = ds.max_nodes(torch.int8, cuda) + 32
    batch, _ = collate_graphs_dense(synthetic_entries(2, n, 38, 6, seed=7), pad_nodes=n, device=cuda)
    model = GINetDense(38, 2, 6, device=cuda, generator=torch.Generator().manual_seed(0))
    cpu_model = GINetDense(38, 2, 6, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    # the CPU's flat route has no shared-memory bound: its batch holds the
    # adjacency as adj, without the flat route's operands, as the collate
    # with with_diag_operands=False gives it
    full = batch.to("cpu")
    cpu_batch = dataclasses.replace(full, adj=full.adj_i8.to(torch.bfloat16), adj_i8=torch.zeros((0, 0, 0), dtype=torch.int8), x_t=torch.zeros((0, 0)))
    for m in (ds, gt):
        m.reset_launches()
    loss_fn = CrossEntropyLoss()
    logits = model(batch)
    loss_fn(logits, batch.y, batch.y_mask).backward()
    torch.cuda.synchronize()
    assert not any(ds.launches.values()) and not any(gt.launches.values())
    cpu_logits = cpu_model(cpu_batch)
    loss_fn(cpu_logits, cpu_batch.y, cpu_batch.y_mask).backward()
    torch.testing.assert_close(logits.detach().cpu(), cpu_logits.detach(), rtol=1e-4, atol=1e-6)
    for (name, p), q in zip(model.named_parameters(), cpu_model.parameters()):
        if q.grad is not None:
            torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=1e-4, atol=1e-6, msg=name)


@pytest.fixture
def cudnn_tf32_default(cuda):
    """cuDNN's TF32 switch at PyTorch's default (on), restored after: the
    CNNs must sum their convolutions in float32 whatever it says."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield cuda
    torch.backends.cudnn.allow_tf32 = before


@pytest.mark.parametrize("shell", [0, 6], ids=["dense_grids", "zero_shell"])
@pytest.mark.parametrize("model", ["CnnClassification", "CnnRegression"])
def test_cnn_step_matches_cpu_with_tf32_at_its_default(cudnn_tf32_default, model, shell) -> None:
    """One step of each CNN at the reference grid protocol's box (33
    features, 35x30x30; 16 grids), card against CPU: logits and loss at
    rtol 1e-4, atol 1e-5; the card's every gradient against the network in
    float64 at tools/f64_gate.py's per-entry gate (relu and max-pool winner
    flips held to their band). On zero-shell grids, with positive conv
    biases, whole pooling windows tie."""
    from deeprank2_tpu_torch.neuralnets.cnn import model3d
    from deeprank2_tpu_torch.ops.batch import collate_grids
    from deeprank2_tpu_torch.ops.losses import MSELoss
    from deeprank2_tpu_torch.ops.synthetic import grid_arrays, grid_entries, zero_shell
    from deeprank2_tpu_torch.tools import f64_gate as fg

    dev = cudnn_tf32_default
    x, y = grid_arrays(16, 33, (35, 30, 30), seed=7)
    if shell:
        x = zero_shell(x, shell)
    batch, _ = collate_grids(grid_entries(x, y), device=dev)
    cls = getattr(model3d, model)
    card = cls(33, (35, 30, 30), device=dev, generator=torch.Generator().manual_seed(0))
    if shell:
        with torch.no_grad():
            for conv in (card.convlayer_000, card.convlayer_002):
                conv.bias.copy_(conv.bias.abs() + 0.05)
    cpu = cls(33, (35, 30, 30), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    loss_fn = CrossEntropyLoss() if model == "CnnClassification" else MSELoss()

    def loss_of(logits, b):
        return loss_fn(logits if logits.shape[1] > 1 else logits.reshape(-1), b.y, b.y_mask)

    logits, losses = {}, {}
    for side, m, b in (("card", card, batch), ("cpu", cpu, batch.to("cpu"))):
        out = m(b)
        loss = loss_of(out, b)
        loss.backward()
        logits[side], losses[side] = out.detach().cpu(), loss.detach().cpu()
    grads = {k: p.grad for k, p in card.named_parameters()}
    row = fg.hold_cnn("card", grads, card.state_dict(), batch.x, lambda lg: loss_of(lg, batch), fg.cnn_decisions(card, batch.x))
    assert torch.backends.cudnn.allow_tf32
    torch.testing.assert_close(logits["card"], logits["cpu"], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(losses["card"], losses["cpu"], rtol=1e-4, atol=1e-5)
    assert row["passed"]


# the graph-parallel shapes of K5: a rank's row slice (all source columns)
# and the ring's buckets (columns re-based to one rank's block), at two and
# three ranks, on a locality-ordered graph of several column chunks
@pytest.mark.parametrize("ranks", [2, 3])
@pytest.mark.parametrize("form", ["row-slice", "ring-diagonal", "ring-off-diagonal"])
def test_bcsr_kernel_at_row_slices_and_ring_buckets(cuda, form, ranks) -> None:
    from deeprank2_tpu_torch.parallel import blocksparse_partition as bp

    pairs, nodes = _bcsr_pairs(2200)
    tiles = -(-nodes // 128)
    r_per = -(-tiles // ranks)
    num_nodes = r_per * ranks * 128
    if form == "row-slice":
        structures = bp._row_slices(pairs, num_nodes, 128, ranks, r_per, None, cuda)
    else:
        rings = bp._build_ring_structures(pairs, num_nodes, 128, ranks, r_per, device=cuda)
        structures = [dg for dg, _, _ in rings] if form == "ring-diagonal" else [s for _, off, _ in rings for s in off]
    gen = torch.Generator(device=cuda).manual_seed(ranks)
    bs.reset_launches()
    for st in structures:
        assert st.padded_rows == r_per * 128 and st.padded_nodes == (num_nodes if form == "row-slice" else r_per * 128)
        x = torch.randn(32, st.padded_nodes, generator=gen, device=cuda)
        torch.testing.assert_close(bs.bcsr_spmm_kernel(st, x), bs.bcsr_spmm_kernel_ref(st, x), **TOL)
        torch.testing.assert_close(bs.bcsr_spmm_kernel(st, x), bs.bcsr_spmm_order_ref(st, x), rtol=0, atol=0)
    assert bs.launches == {"bcsr_spmm_kernel": 2 * len(structures)}
