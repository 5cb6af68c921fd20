"""The port's dense collate (deeprank2_tpu_torch/ops/batch.py) against the JAX
package's (deeprank2_tpu/ops/batch.py), array for array, on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deeprank2_tpu.ops import batch as jbatch
from deeprank2_tpu.ops.synthetic import synthetic_entries as jax_synthetic_entries
from deeprank2_tpu_torch.ops import batch as tbatch
from deeprank2_tpu_torch.ops.synthetic import synthetic_entries


def _entries(num_graphs, nodes, feat, seed):
    """Graphs of varying size (ragged nodes, one without a target)."""
    entries = synthetic_entries(num_graphs, nodes, feat, 4, seed=seed)
    rng = np.random.default_rng(seed)
    for e in entries[1:]:
        v = int(rng.integers(nodes // 2, nodes + 1))
        e["x"] = e["x"][:v]
        e["pos"] = e["pos"][:v]
        keep = (e["edge_index"] < v).all(axis=1)
        e["edge_index"] = e["edge_index"][keep]
    entries[-1]["y"] = None
    return entries


def test_synthetic_entries_match_jax() -> None:
    ours = synthetic_entries(3, 20, 7, 2, seed=11)
    theirs = jax_synthetic_entries(3, 20, 7, 2, seed=11)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))


@pytest.mark.parametrize(
    ("num_graphs", "nodes", "feat", "pad_graphs", "pad_nodes"),
    [(4, 32, 10, None, None), (5, 90, 38, 8, 96), (3, 20, 38, 16, None), (16, 32, 10, 16, 32)],
)
def test_collate_graphs_dense_matches_jax(num_graphs, nodes, feat, pad_graphs, pad_nodes) -> None:
    entries = _entries(num_graphs, nodes, feat, seed=num_graphs + nodes)
    want, want_names = jbatch.collate_graphs_dense(entries, pad_graphs=pad_graphs, pad_nodes=pad_nodes)
    got, names = tbatch.collate_graphs_dense(entries, pad_graphs=pad_graphs, pad_nodes=pad_nodes, device="cpu")
    assert names == want_names
    assert got.x.device == torch.device("cpu")
    assert (got.num_graphs, got.nodes_per_graph) == (want.num_graphs, want.nodes_per_graph)
    for field, dtype in [("x", torch.float32), ("adj_i8", torch.int8), ("x_t", torch.float32), ("node_mask", torch.bool), ("y", torch.float32), ("y_mask", torch.bool)]:
        ours = getattr(got, field)
        assert ours.dtype == dtype, field
        assert ours.is_contiguous(), field
        np.testing.assert_array_equal(ours.numpy(), np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_array_equal(got.adj_i8.numpy(), np.asarray(want.adj, np.float32).astype(np.int8))


def test_bucket_size_matches_jax() -> None:
    for quantum in (8, 32, 128):
        for n in range(0, 3000, 7):
            assert tbatch.bucket_size(n, quantum) == jbatch.bucket_size(n, quantum)


def test_collate_rejects_what_is_not_ported_or_does_not_fit() -> None:
    entries = synthetic_entries(2, 40, 5, 2, seed=1)
    with pytest.raises(NotImplementedError):
        tbatch.collate_graphs_dense(entries, with_clusters=True, device="cpu")
    with pytest.raises(NotImplementedError):
        tbatch.collate_graphs_dense(entries, with_edge_weights=True, device="cpu")
    with pytest.raises(ValueError, match="exceeds dense node capacity"):
        tbatch.collate_graphs_dense(entries, pad_nodes=32, device="cpu")
    with pytest.raises(ValueError, match="smaller than"):
        tbatch.collate_graphs_dense(entries, pad_graphs=1, device="cpu")
