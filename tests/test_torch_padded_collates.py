"""The port's capacity buckets for the Trainer's block-sparse, clustered
block-sparse and blocked-edge branches (deeprank2_tpu_torch) against the JAX
package's on the CPU: ``required_blocks``, ``build_blocksparse``'s
``pad_blocks_to``, the three requirements passes and each collate with its
capacities given as ints and as callables, field for field and exactly; the
plain versions of K5, K3/K4 and K6f/K6b on the padded structures against
JAX's XLA functions and its interpreted slot kernel, at the tolerances of
their existing tests (K5 and K6f rtol=atol=1e-5, K6b's gradients rtol 1e-4,
atol 1e-5, the slot kernels exactly); and the Trainer's ``_map_tensors``,
which reaches the tensors of the nested structures. The column chunks of
both packages are cut to a few tiles, so that the structures have several."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeprank2_tpu.ops.block_sparse as jbs
from deeprank2_tpu.ops import batch as jbatch
from deeprank2_tpu.ops import blocked_edges as jbe
from deeprank2_tpu.ops.pallas_slotpool import slot_group_max as jax_slot_group_max
from deeprank2_tpu_torch import trainer as port_trainer
from deeprank2_tpu_torch.ops import batch as tbatch
from deeprank2_tpu_torch.ops import block_sparse as tbs
from deeprank2_tpu_torch.ops import slotpool as sp
from deeprank2_tpu_torch.ops import vanilla as tv
from deeprank2_tpu_torch.ops.synthetic import clustered_entry, geometric_entry, synthetic_entries

FEAT = 38
TOL = {"rtol": 1e-5, "atol": 1e-5}
GRAD_TOL = {"rtol": 1e-4, "atol": 1e-5}
EXACT = {"rtol": 0, "atol": 0}
# capacity sets: ints that leave room, and the Trainer's kind, callables
BCSR_PADS = {"ints": {"pad_tiles": 30, "pad_blocks": 1000}, "callables": {"pad_tiles": lambda r: r + 3, "pad_blocks": lambda r: r + 130}}
CLUSTERED_PADS = {
    "ints": {"pad_tiles": 50, "pad_blocks": 2000, "pad_pooled_tiles": 5, "pad_pooled_blocks": 300, "pad_c1": 40, "pad_members0": 80, "pad_members1": 10, "pad_members0s": 12},
    "callables": {
        "pad_tiles": lambda r: r + 5,
        "pad_blocks": lambda r: r + 20,
        "pad_pooled_tiles": lambda r: r + 2,
        "pad_pooled_blocks": lambda r: r + 9,
        "pad_c1": lambda r: r + 7,
        "pad_members0": lambda r: r + 1,
        "pad_members1": lambda r: r + 2,
        "pad_members0s": lambda r: r + 3,
    },
}
BLOCKED_PADS = {"ints": {"pad_tiles": 14, "pad_slabs": 80}, "callables": {"pad_tiles": lambda r: r + 2, "pad_slabs": lambda r: r + 5}}


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    for module in (jbs, tbs):
        monkeypatch.setattr(module, "CHUNK_TILES", 2)
    for module in (jbatch, tbatch):
        monkeypatch.setattr(module, "_CLUSTERED_CHUNK_TILES", 3)


def _geometric(edge_dim=1):
    entries = [geometric_entry(n, FEAT, edge_dim, seed=i) for i, n in enumerate((700, 1300, 300))]
    entries[-1]["y"] = None
    return entries


def _clustered():
    entries = [clustered_entry(n, FEAT, seed=10 + i) for i, n in enumerate((3000, 1300, 300))]
    for i, e in enumerate(entries):
        e["entry_name"] = f"c{i}"
    entries[-1]["y"] = None
    return entries


def _assert_equal(got, want, what):
    """Field for field, the structures' JAX fields included; bf16 by value."""
    for f in dataclasses.fields(want):
        if f.metadata.get("static"):
            assert getattr(got, f.name) == getattr(want, f.name), f"{what}.{f.name}"
            continue
        ours, theirs = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(theirs):
            _assert_equal(ours, theirs, f"{what}.{f.name}")
            continue
        theirs = np.asarray(theirs)
        if theirs.dtype.name == "bfloat16":
            assert ours.dtype == torch.bfloat16, f"{what}.{f.name}"
            ours, theirs = ours.float(), theirs.astype(np.float32)
        assert ours.numpy().dtype == theirs.dtype, f"{what}.{f.name}"
        np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=f"{what}.{f.name}")


@pytest.mark.parametrize("kw", [{}, {"kbatch": 1}, {"kbatch": 4, "chunk_tiles": 3}], ids=["default", "real-blocks", "kbatch4-chunk3"])
def test_required_blocks_matches_jax(kw) -> None:
    entries = _geometric()
    layout = tbatch.blocksparse_layout(entries, features=False)
    n = layout["num_tiles"] * 128
    assert tbs.required_blocks(layout["pairs"], n, **kw) == jbs.required_blocks(layout["pairs"], n, **kw)
    assert tbs.required_blocks(np.zeros((0, 2), np.int64), 300, **kw) == jbs.required_blocks(np.zeros((0, 2), np.int64), 300, **kw)


@pytest.mark.parametrize("pad", [None, 700, lambda r: r + 200], ids=["none", "int", "callable"])
def test_pad_blocks_to_matches_jax_and_the_index_skips_the_padding(pad) -> None:
    entries = _geometric()
    layout = tbatch.blocksparse_layout(entries, features=False)
    n = layout["num_tiles"] * 128
    ours = tbs.build_blocksparse(layout["pairs"], n, pad_blocks_to=pad, device="cpu")
    theirs = jbs.build_blocksparse(layout["pairs"], n, pad_blocks_to=pad, to_device=False)
    _assert_equal(ours, theirs, "structure")
    required = tbs.required_blocks(layout["pairs"], n)
    assert ours.num_blocks >= max(required, pad if isinstance(pad, int) else 0)
    # K5's index lists the nonzero blocks only: run and capacity padding are never read
    nonzero = np.flatnonzero(ours.blocks_t.numpy().any(axis=(1, 2)))
    np.testing.assert_array_equal(np.sort(ours.tile_blocks.numpy()), nonzero)
    with pytest.raises(ValueError, match="pad_blocks"):
        tbs.build_blocksparse(layout["pairs"], n, pad_blocks_to=required - 1, device="cpu")


@pytest.mark.parametrize("pads", sorted(BCSR_PADS))
def test_blocksparse_requirements_and_padded_collate_match_jax(pads) -> None:
    entries = _geometric()
    assert tbatch.blocksparse_requirements(entries) == jbatch.blocksparse_requirements(entries)
    want, want_names = jbatch.collate_graphs_blocksparse(entries, pad_graphs=4, **BCSR_PADS[pads])
    got, names = tbatch.collate_graphs_blocksparse(entries, pad_graphs=4, device="cpu", **BCSR_PADS[pads])
    assert names == want_names
    tiles, blocks = tbatch.blocksparse_requirements(entries)
    assert got.structure.num_tiles > tiles and got.structure.num_blocks > blocks
    _assert_equal(got, want, "batch")
    with pytest.raises(ValueError, match="pad_tiles"):
        tbatch.collate_graphs_blocksparse(entries, pad_tiles=tiles - 1, device="cpu")


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("slot8", [True, False], ids=["slot8", "plain"])
@pytest.mark.parametrize("pads", sorted(CLUSTERED_PADS))
def test_clustered_requirements_and_padded_collate_match_jax(pads, slot8, weighted) -> None:
    entries = _clustered()
    req = tbatch.clustered_blocksparse_requirements(entries, slot8=slot8)
    assert req == jbatch.clustered_blocksparse_requirements(entries, slot8=slot8)
    kw = dict(CLUSTERED_PADS[pads], pad_graphs=4, slot8=slot8, with_edge_weights=weighted)
    if not slot8:
        kw.pop("pad_members0s")
    want, want_names = jbatch.collate_graphs_blocksparse_clustered(entries, **kw)
    got, names = tbatch.collate_graphs_blocksparse_clustered(entries, device="cpu", **kw)
    assert names == want_names
    assert got.structure.num_tiles >= req["tiles"] and got.structure_p.num_tiles > req["pooled_tiles"]
    assert got.c1_graph.numel() > req["c1"] and got.members1.shape[1] > req["members1_s"]
    _assert_equal(got, want, "batch")


@pytest.mark.parametrize("pads", sorted(BLOCKED_PADS))
def test_blocked_requirements_and_padded_collate_match_jax(pads) -> None:
    entries = _geometric(edge_dim=6)
    assert tbatch.blocked_requirements(entries) == jbatch.blocked_requirements(entries)
    want, want_names = jbatch.collate_graphs_blocked(entries, pad_graphs=4, **BLOCKED_PADS[pads])
    got, names = tbatch.collate_graphs_blocked(entries, pad_graphs=4, device="cpu", **BLOCKED_PADS[pads])
    assert names == want_names
    tiles, slabs = tbatch.blocked_requirements(entries)
    assert got.structure.num_node_tiles > tiles and got.structure.num_slabs > slabs
    _assert_equal(got, want, "batch")


def test_k5_plain_version_on_padded_structures_matches_bcsr_spmm_xla() -> None:
    """Padding tiles and blocks, full and pooled, int8 and bf16 blocks."""
    cases = [
        ("bcsr", *(c(_geometric(), pad_graphs=4, **BCSR_PADS["callables"]) for c in (jbatch.collate_graphs_blocksparse, _cpu(tbatch.collate_graphs_blocksparse)))),
    ]
    for weighted in (False, True):
        kw = dict(CLUSTERED_PADS["callables"], pad_graphs=4, slot8=True, with_edge_weights=weighted)
        pair = (jbatch.collate_graphs_blocksparse_clustered(_clustered(), **kw), _cpu(tbatch.collate_graphs_blocksparse_clustered)(_clustered(), **kw))
        cases.append((f"clustered {'bf16' if weighted else 'int8'}", *pair))
    rng = np.random.default_rng(0)
    for name, (jb, _), (tb, _) in cases:
        for field in ("structure", "structure_p") if hasattr(tb, "structure_p") else ("structure",):
            ours, theirs = getattr(tb, field), getattr(jb, field)
            x = rng.normal(size=(ours.padded_nodes, 16)).astype(np.float32)
            want = np.asarray(jbs.bcsr_spmm_xla(theirs, jnp.asarray(x)))
            got = tbs.bcsr_spmm_kernel_ref(ours, torch.from_numpy(np.ascontiguousarray(x.T)))
            np.testing.assert_allclose(got.numpy().T, want, **TOL, err_msg=f"{name} {field}")


def _cpu(collate):
    return lambda *a, **kw: collate(*a, device="cpu", **kw)


def test_slot_kernels_plain_versions_at_a_padded_width_match_the_interpreted_kernel() -> None:
    """K3/K4's plain version at the padded node width of a bucketed slot8
    batch (its padding tiles hold masked lanes only) against the JAX kernel
    in interpret mode, exactly."""
    tb, _ = tbatch.collate_graphs_blocksparse_clustered(_clustered(), pad_graphs=4, slot8=True, device="cpu", **CLUSTERED_PADS["callables"])
    mask_row = tb.node_mask.float().reshape(1, -1).numpy()
    v = mask_row.shape[1]
    rng = np.random.default_rng(3)
    h = np.abs(rng.standard_normal((16, v))).astype(np.float32) * mask_row
    cot = rng.standard_normal((16, v // 8)).astype(np.float32)
    pooled, vjp = jax.vjp(lambda a: jax_slot_group_max(a, jnp.asarray(mask_row), interpret=True, slot=8), jnp.asarray(h))
    x = torch.from_numpy(h).requires_grad_(True)
    got = sp.slot_group_max_ref(x, torch.from_numpy(mask_row), slot=8)
    (dh,) = torch.autograd.grad(got, x, torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(pooled), **EXACT)
    np.testing.assert_allclose(dh.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), **EXACT)


def test_blocked_plain_versions_on_padded_structures_match_jax() -> None:
    """K6f/K6b's plain versions with padding tiles and slabs against jax.vjp
    of ``blocked_message_sum_xla``."""
    entries = _geometric(edge_dim=6)
    jb, _ = jbatch.collate_graphs_blocked(entries, pad_graphs=4, **BLOCKED_PADS["callables"])
    tb, _ = tbatch.collate_graphs_blocked(entries, pad_graphs=4, device="cpu", **BLOCKED_PADS["callables"])
    st = tb.structure
    rng = np.random.default_rng(5)
    xr, xc, g = (rng.normal(size=(st.padded_nodes, 12)).astype(np.float32) for _ in range(3))
    w_e = rng.normal(size=(st.edge_dim, 12)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jbe.blocked_message_sum_xla(jb.structure, a, b, c), *map(jnp.asarray, (xr, xc, w_e)))
    t = [torch.from_numpy(a) for a in (xr, xc, w_e, g)]
    np.testing.assert_allclose(tv.blocked_fwd_kernel_ref(st, *t[:3]).numpy(), np.asarray(out), **TOL)
    for name, got, want in zip(("dxr", "dxc", "dw_e"), tv.blocked_bwd_kernel_ref(st, *t), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL, err_msg=name)


def _batches() -> dict:
    return {
        "dense": tbatch.collate_graphs_dense(synthetic_entries(3, 20, FEAT, 2, seed=1), device="cpu")[0],
        "bcsr": tbatch.collate_graphs_blocksparse(_geometric(), device="cpu", **BCSR_PADS["callables"])[0],
        "clustered_bcsr": tbatch.collate_graphs_blocksparse_clustered(_clustered(), slot8=True, with_edge_weights=True, device="cpu")[0],
        "blocked": tbatch.collate_graphs_blocked(_geometric(edge_dim=6), device="cpu", **BLOCKED_PADS["callables"])[0],
    }


def _all_tensors(obj) -> list[torch.Tensor]:
    out = []
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        out += [value] if isinstance(value, torch.Tensor) else _all_tensors(value) if dataclasses.is_dataclass(value) else []
    return out


@pytest.mark.parametrize("kind", ["dense", "bcsr", "clustered_bcsr", "blocked"])
def test_map_tensors_maps_every_tensor_of_nested_batches(kind) -> None:
    """Every tensor, those of ``structure`` and ``structure_p`` included, goes
    through the loader's function (pin, copy, ``record_stream``); the
    static ints stay as they are."""
    batch = _batches()[kind]
    tensors = _all_tensors(batch)
    assert [id(t) for t in port_trainer._tensor_fields(batch)] == [id(t) for t in tensors]
    seen = []

    def mark(t):
        seen.append(id(t))
        return t + 1 if t.dtype.is_floating_point else t.clone()

    mapped = port_trainer._map_tensors(batch, mark)
    assert seen == [id(t) for t in tensors]
    new = _all_tensors(mapped)
    assert len(new) == len(tensors) and not {id(t) for t in new} & {id(t) for t in tensors}
    for a, b in zip(new, tensors):
        torch.testing.assert_close(a, b + 1 if b.dtype.is_floating_point else b, rtol=0, atol=0)
    for name in ("structure", "structure_p"):
        if hasattr(batch, name):
            st, st2 = getattr(batch, name), getattr(mapped, name)
            assert type(st2) is type(st)
            for f in dataclasses.fields(st):
                if not isinstance(getattr(st, f.name), torch.Tensor):
                    assert getattr(st2, f.name) == getattr(st, f.name), f.name
    if hasattr(batch, "num_graphs") and not isinstance(batch.num_graphs, property):
        assert mapped.num_graphs == batch.num_graphs
