"""The port's segment ops and community pooling (deeprank2_tpu_torch/ops/
{segment,pooling}.py) against the JAX package's on the CPU, values and
gradients. Max paths involve no sums and must agree exactly; sums and means
agree to summation order (1e-6)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprank2_tpu.ops import pooling as jpool
from deeprank2_tpu.ops import segment as jseg
from deeprank2_tpu.ops.batch import _member_matrix
from deeprank2_tpu.ops.batch import collate_graphs_diag_clustered as jax_collate
from deeprank2_tpu_torch.ops import pooling as tpool
from deeprank2_tpu_torch.ops import segment as tseg
from deeprank2_tpu_torch.ops import slotpool as sp
from deeprank2_tpu_torch.ops.batch import collate_graphs_diag_clustered
from deeprank2_tpu_torch.ops.synthetic import ppi_clustered_entries

EXACT = {"rtol": 0, "atol": 0}
MEAN = {"rtol": 1e-6, "atol": 1e-6}


def _jax_vjp(fn, x, cot):
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


def _torch_vjp(fn, x, cot):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(xt)
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(cot))
    return out.detach().numpy(), grad.numpy()


def _segments(rows: int, feat: int, num: int, seed: int):
    """Rows with ids in [0, num] — id ``num`` is padding and must be dropped —
    some segments empty, and exact ties inside segments."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, num + 1, size=rows).astype(np.int32)
    ids[ids == 2] = num  # segment 2 stays empty
    data = rng.standard_normal((rows, feat)).astype(np.float32)
    data[1] = data[0]
    ids[1] = ids[0]  # a tie
    data[5:8] = 0.0  # zero rows (post-relu ties at 0)
    return data, ids


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean", "segment_max"])
@pytest.mark.parametrize(("rows", "feat", "num"), [(60, 5, 9), (200, 16, 31)])
def test_segment_ops_match_jax(op, rows, feat, num) -> None:
    data, ids = _segments(rows, feat, num, seed=rows + feat)
    cot = np.random.default_rng(num).standard_normal((num, feat)).astype(np.float32)
    want, want_grad = _jax_vjp(lambda d: getattr(jseg, op)(d, jnp.asarray(ids), num), data, cot)
    got, got_grad = _torch_vjp(lambda d: getattr(tseg, op)(d, torch.from_numpy(ids), num), data, cot)
    tol = EXACT if op == "segment_max" else MEAN
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got_grad, want_grad, **tol)
    if op == "segment_max":
        assert (got[2] == 0).all()  # an empty segment gives 0


def test_segment_count_matches_jax() -> None:
    _, ids = _segments(50, 1, 7, seed=2)
    valid = np.random.default_rng(2).random(50) > 0.3
    for v in (None, valid):
        want = jseg.segment_count(jnp.asarray(ids), 7, None if v is None else jnp.asarray(v))
        got = tseg.segment_count(torch.from_numpy(ids), 7, None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(("rows", "feat", "num"), [(48, 6, 10), (160, 32, 24)])
def test_member_max_pool_matches_jax(rows, feat, num) -> None:
    rng = np.random.default_rng(rows)
    cluster = rng.integers(0, num + 1, size=rows).astype(np.int32)  # id num = padding
    h = np.abs(rng.standard_normal((rows, feat))).astype(np.float32)
    h[cluster == num] = 0.0
    h[4] = h[3]
    cluster[4] = cluster[3]  # a tie between two members
    members = _member_matrix(cluster, num, rows)
    assert members.size
    cot = rng.standard_normal((num, feat)).astype(np.float32)
    want, want_grad = _jax_vjp(lambda x: jpool.member_max_pool(x, jnp.asarray(members), jnp.asarray(cluster)), h, cot)
    got, got_grad = _torch_vjp(lambda x: tpool.member_max_pool(x, torch.from_numpy(members), torch.from_numpy(cluster)), h, cot)
    np.testing.assert_allclose(got, want, **EXACT)
    np.testing.assert_allclose(got_grad, want_grad, **EXACT)
    # both tied members get the full cotangent
    np.testing.assert_array_equal(got_grad[3][h[3] == got[cluster[3]]], cot[cluster[3]][h[3] == got[cluster[3]]])
    np.testing.assert_array_equal(got_grad[3], got_grad[4])


@pytest.mark.parametrize(
    ("nodes", "cell", "min_slot_nodes", "layout"),
    [(40, 10.0, 1, "pure"), (160, 10.0, None, "pure"), (40, 6.0, None, "mixed"), (160, 10.0, 5, "mixed")],
)
def test_diag_depth0_pool_matches_jax(nodes, cell, min_slot_nodes, layout) -> None:
    entries = ppi_clustered_entries(5, nodes, 7, cell=cell, seed=nodes)
    jbatch, _ = jax_collate(entries, pad_graphs=6, min_slot_nodes=min_slot_nodes)
    tbatch, _ = collate_graphs_diag_clustered(entries, pad_graphs=6, min_slot_nodes=min_slot_nodes, device="cpu")
    assert bool(tbatch.region_caps) == (layout == "mixed")
    g, n, _ = tbatch.adj_i8.shape
    k = tbatch.pooled_mask.shape[1]
    rng = np.random.default_rng(nodes)
    h = np.maximum(rng.standard_normal((12, g * n)), 0.0).astype(np.float32) * tbatch.node_mask.numpy().reshape(1, -1)
    cot = rng.standard_normal((12, g * k)).astype(np.float32)
    jb = jax.tree.map(jnp.asarray, jbatch)
    want, want_grad = _jax_vjp(lambda x: jpool.diag_depth0_pool(x, jb), h, cot)
    sp.reset_launches()
    got, got_grad = _torch_vjp(lambda x: tpool.diag_depth0_pool(x, tbatch), h, cot)
    assert sp.launches == {"slot_fwd_kernel": 0, "slot_bwd_kernel": 0}
    np.testing.assert_allclose(got, want, **EXACT)
    np.testing.assert_allclose(got_grad, want_grad, **EXACT)
    # padded pooled slots stay 0
    assert (got.reshape(12, g, k)[:, ~tbatch.pooled_mask.numpy()] == 0).all()


def test_diag_depth0_pool_without_member_matrices_uses_segment_max() -> None:
    """The member-matrix size guard (one huge cluster) leaves ``members0s``
    empty; both packages then pool through segment_max."""
    entries = ppi_clustered_entries(3, 40, 5, cell=10.0, seed=4)
    jbatch, _ = jax_collate(entries, min_slot_nodes=1)
    tbatch, _ = collate_graphs_diag_clustered(entries, min_slot_nodes=1, device="cpu")
    jbatch.members0s = np.zeros((0, 0), np.int32)
    tbatch.members0s = torch.zeros((0, 0), dtype=torch.int32)
    g, n, _ = tbatch.adj_i8.shape
    rng = np.random.default_rng(0)
    h = np.maximum(rng.standard_normal((4, g * n)), 0.0).astype(np.float32) * tbatch.node_mask.numpy().reshape(1, -1)
    cot = rng.standard_normal((4, tbatch.pooled_mask.numel())).astype(np.float32)
    jb = jax.tree.map(jnp.asarray, jbatch)
    want, want_grad = _jax_vjp(lambda x: jpool.diag_depth0_pool(x, jb), h, cot)
    got, got_grad = _torch_vjp(lambda x: tpool.diag_depth0_pool(x, tbatch), h, cot)
    np.testing.assert_allclose(got, want, **EXACT)
    np.testing.assert_allclose(got_grad, want_grad, **EXACT)
