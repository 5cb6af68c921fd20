"""The port's FoutNet and sGAT slice (deeprank2_tpu_torch: the COO ``FoutNet``
and ``SGAT``, ``FoutNetDiag``, ``SGATDiag``, ``FoutNetBlockSparse``,
``SGATBlockSparse``, and the ``"foutnet"``/``"sgat"`` parameter families)
against the JAX package's on the CPU, with one JAX initialisation carried
across by ``param_interop``:

- the COO models against the JAX COO models: logits and loss at rtol 1e-4 /
  atol 1e-5, every gradient at rtol 1e-4 / atol 1e-6 (f32 on both sides, as
  tests/test_torch_coo.py);
- the four fast models against their JAX twins on the same batch (bf16 and
  f32 weight storage for sGAT): logits at 1e-4, gradients at 1e-3
  (tests/utils/test_diag_clustered.py:38,45,
  tests/utils/test_clustered_blocksparse.py:88,104), and against the port's
  own COO oracle at the same gates on the data of those JAX tests;
- the bf16-storage sGAT models against the f32-storage ones at 2e-2
  (test_clustered_blocksparse.py:178-188);
- one Adam step of each model against JAX's, at 1e-4 / 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeprank2_tpu.ops.block_sparse as jbs
from deeprank2_tpu.neuralnets.gnn import clustered_blocksparse as jcb
from deeprank2_tpu.neuralnets.gnn import foutnet as jfout
from deeprank2_tpu.neuralnets.gnn import sgat as jsgat
from deeprank2_tpu.ops import batch as jbatch
from deeprank2_tpu.ops.losses import CrossEntropyLoss as JaxCrossEntropyLoss
from deeprank2_tpu.ops.optim import Adam as JaxAdam
from deeprank2_tpu_torch.neuralnets.gnn.clustered_blocksparse import FoutNetBlockSparse, SGATBlockSparse
from deeprank2_tpu_torch.neuralnets.gnn.foutnet import FoutNet, FoutNetDiag
from deeprank2_tpu_torch.neuralnets.gnn.sgat import SGAT, SGATDiag
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax, params_to_jax
from deeprank2_tpu_torch.ops import batch as tbatch
from deeprank2_tpu_torch.ops import block_sparse as tbs
from deeprank2_tpu_torch.ops import diag_spmm as ds
from deeprank2_tpu_torch.ops import slotpool as sp
from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
from deeprank2_tpu_torch.ops.optim import Adam
from deeprank2_tpu_torch.ops.synthetic import clustered_entry, ppi_clustered_entries
from tests.utils.test_clustered_blocksparse import _clustered_entries

FEAT = 13
TOL = {"rtol": 1e-4, "atol": 1e-5}
GRAD_TOL = {"rtol": 1e-4, "atol": 1e-6}
FAST_TOL = {"rtol": 1e-4, "atol": 1e-4}  # logits of a fast model (JAX tests' gate)
FAST_GRAD_TOL = {"rtol": 1e-3, "atol": 1e-3}
STORAGE = {"bf16": (torch.bfloat16, None), "f32": (torch.float32, np.float32)}

# model -> (family, JAX class, port class, layout, weighted)
MODELS = {
    "foutnet": ("foutnet", jfout.FoutNet, FoutNet, "coo", False),
    "sgat": ("sgat", jsgat.SGAT, SGAT, "coo", True),
    "foutnet_diag": ("foutnet", jfout.FoutNetDiag, FoutNetDiag, "diag", False),
    "sgat_diag": ("sgat", jsgat.SGATDiag, SGATDiag, "diag", True),
    "foutnet_bcsr": ("foutnet", jcb.FoutNetBlockSparse, FoutNetBlockSparse, "bcsr", False),
    "sgat_bcsr": ("sgat", jcb.SGATBlockSparse, SGATBlockSparse, "bcsr", True),
}
# layout variant -> (entries, collate keyword arguments)
VARIANTS = {
    "coo": (lambda: ppi_clustered_entries(4, 40, FEAT, seed=2), {}),
    "pure": (lambda: ppi_clustered_entries(4, 40, FEAT, seed=2), {"min_slot_nodes": 1}),
    "mixed": (lambda: ppi_clustered_entries(4, 40, FEAT, cell=6.0, seed=2), {"min_slot_nodes": 5}),
    "slot8": (lambda: [clustered_entry(n, FEAT, seed=30 + i) for i, n in enumerate((2500, 900))], {"slot8": True}),
    "plain": (lambda: [clustered_entry(n, FEAT, seed=30 + i) for i, n in enumerate((2500, 900))], {"slot8": False}),
}
PAD_GRAPHS = 5


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    """Several column chunks in the BCSR structures of both packages."""
    for module in (jbs, tbs):
        monkeypatch.setattr(module, "CHUNK_TILES", 2)
    for module in (jbatch, tbatch):
        monkeypatch.setattr(module, "_CLUSTERED_CHUNK_TILES", 3)


def _collate_both(layout, entries, weighted, storage="bf16", **kw):
    tdt, jdt = STORAGE[storage]
    wkw = ({"with_edge_weights": True, "weight_dtype": jdt}, {"with_edge_weights": True, "weight_dtype": tdt}) if weighted else ({}, {})
    if layout == "coo":
        jb, _ = jbatch.collate_graphs(entries, pad_graphs=PAD_GRAPHS)
        tb, _ = tbatch.collate_graphs(entries, pad_graphs=PAD_GRAPHS, device="cpu")
    elif layout == "diag":
        jb, _ = jbatch.collate_graphs_diag_clustered(entries, pad_graphs=PAD_GRAPHS, **wkw[0], **kw)
        tb, _ = tbatch.collate_graphs_diag_clustered(entries, pad_graphs=PAD_GRAPHS, device="cpu", **wkw[1], **kw)
    else:
        jb, _ = jbatch.collate_graphs_blocksparse_clustered(entries, pad_graphs=PAD_GRAPHS, **wkw[0], **kw)
        tb, _ = tbatch.collate_graphs_blocksparse_clustered(entries, pad_graphs=PAD_GRAPHS, device="cpu", **wkw[1], **kw)
    return jb, tb


def _setup(name, variant, storage="bf16", seed=0):
    family, jcls, cls, layout, weighted = MODELS[name]
    make, kw = VARIANTS[variant]
    entries = make()
    entries[1]["y"] = 0.0
    entries[-1]["y"] = None  # a graph without a target
    jb, tb = _collate_both(layout, entries, weighted, storage, **kw)
    jmodel = jcls(FEAT, 2, 1)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    model = cls(FEAT, 2, 1, device="cpu")
    model.load_state_dict(params_from_jax(params, family))
    return jmodel, params, jb, model, tb, family


def _jax_loss(jmodel, jb):
    def compute(p):
        return JaxCrossEntropyLoss()(jmodel.apply(p, jb, training=False), jb.y.astype(jnp.int32), jb.y_mask)

    return compute


def _assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path), **tol)


def _grads(model, family):
    return params_to_jax({k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in model.named_parameters()}, family)


# (model, layout variant, weight storage)
CASES = [
    ("foutnet", "coo", "bf16"),
    ("sgat", "coo", "bf16"),
    ("foutnet_diag", "pure", "bf16"),
    ("foutnet_diag", "mixed", "bf16"),
    ("sgat_diag", "pure", "bf16"),
    ("sgat_diag", "pure", "f32"),
    ("sgat_diag", "mixed", "bf16"),
    ("foutnet_bcsr", "slot8", "bf16"),
    ("foutnet_bcsr", "plain", "bf16"),
    ("sgat_bcsr", "slot8", "bf16"),
    ("sgat_bcsr", "slot8", "f32"),
    ("sgat_bcsr", "plain", "bf16"),
]


@pytest.mark.parametrize(("name", "variant", "storage"), CASES)
def test_logits_loss_and_every_gradient_match_jax(name, variant, storage) -> None:
    jmodel, params, jb, model, tb, family = _setup(name, variant, storage)
    want_logits = np.asarray(jmodel.apply(params, jb))
    loss_want, grads_want = jax.value_and_grad(_jax_loss(jmodel, jb))(params)
    for m in (ds, sp, tbs):
        m.reset_launches()
    logits = model(tb)
    loss = CrossEntropyLoss()(logits, tb.y, tb.y_mask)
    loss.backward()
    # on the CPU every wrapper takes its plain version
    assert not any(v for m in (ds, sp, tbs) for v in m.launches.values())
    assert logits.shape == (PAD_GRAPHS, 2)
    coo = MODELS[name][3] == "coo"
    logit_tol, grad_tol = (TOL, GRAD_TOL) if coo else (FAST_TOL, FAST_GRAD_TOL)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, **logit_tol)
    np.testing.assert_allclose(float(loss.detach()), float(loss_want), **logit_tol)
    grads = _grads(model, family)
    _assert_trees_close(grads, jax.tree.map(np.asarray, grads_want), **grad_tol)
    for layer in ("conv1", "conv2", "fc1", "fc2"):
        assert max(np.abs(v).max() for v in grads[layer].values()) > 0, layer


@pytest.mark.parametrize(("name", "variant"), [("foutnet_diag", "pure"), ("sgat_diag", "pure"), ("foutnet_bcsr", "slot8"), ("sgat_bcsr", "slot8")])
def test_fast_models_match_the_coo_oracle(name, variant) -> None:
    """The JAX tests' check of each fast model against its COO twin
    (f32 weight storage, the loss ``sum(logits[:3]^2)``), on the port."""
    family, _, cls, layout, weighted = MODELS[name]
    coo_cls = {"foutnet": FoutNet, "sgat": SGAT}[family]
    entries = _clustered_entries(edge_dim=1)
    _, coo_batch = _collate_both("coo", entries, False)
    kw = VARIANTS[variant][1]
    _, fast_batch = _collate_both(layout, entries, weighted, "f32", **kw)
    oracle = coo_cls(13, 2, 1, device="cpu", generator=torch.Generator().manual_seed(4))
    fast = cls(13, 2, 1, device="cpu")
    fast.load_state_dict(oracle.state_dict())
    results = []
    for m, b in ((oracle, coo_batch), (fast, fast_batch)):
        out = m(b)
        (out[:3] ** 2).sum().backward()
        results.append((out.detach()[:3], {k: p.grad for k, p in m.named_parameters()}))
    (want, want_grads), (got, got_grads) = results
    torch.testing.assert_close(got, want, **FAST_TOL)
    for k in want_grads:
        torch.testing.assert_close(got_grads[k], want_grads[k], **FAST_GRAD_TOL, msg=k)


@pytest.mark.parametrize(("name", "variant"), [("sgat_diag", "pure"), ("sgat_diag", "mixed"), ("sgat_bcsr", "slot8")])
def test_bf16_weight_storage_stays_within_its_band(name, variant) -> None:
    _, _, cls, layout, _ = MODELS[name]
    entries, kw = VARIANTS[variant][0](), VARIANTS[variant][1]
    model = cls(FEAT, 2, 1, device="cpu", generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        exact = model(_collate_both(layout, entries, True, "f32", **kw)[1])
        prod = model(_collate_both(layout, entries, True, "bf16", **kw)[1])
    torch.testing.assert_close(prod, exact, rtol=2e-2, atol=2e-2)
    assert (prod - exact).abs().max() > 0  # the two storages really differ


@pytest.mark.parametrize(("name", "variant"), [("foutnet", "coo"), ("sgat", "coo"), ("foutnet_diag", "pure"), ("sgat_diag", "mixed"), ("foutnet_bcsr", "slot8"), ("sgat_bcsr", "plain")])
def test_one_adam_step_matches_jax(name, variant) -> None:
    jmodel, params, jb, model, tb, family = _setup(name, variant, seed=1)
    jopt = JaxAdam(lr=1e-3, weight_decay=1e-5)
    jparams, _ = jopt.step(params, jax.grad(_jax_loss(jmodel, jb))(params), jopt.init(params))
    opt = Adam(model.parameters(), lr=1e-3, weight_decay=1e-5)
    opt.zero_grad()
    CrossEntropyLoss()(model(tb), tb.y, tb.y_mask).backward()
    opt.step()
    _assert_trees_close(params_to_jax(model.state_dict(), family), jax.tree.map(np.asarray, jparams), **TOL)


@pytest.mark.parametrize("family", ["foutnet", "sgat"])
def test_parameter_families_round_trip(family) -> None:
    names = [n for n, m in MODELS.items() if m[0] == family]
    params = jax.tree.map(np.asarray, MODELS[names[0]][1](FEAT, 2, 1).init(jax.random.PRNGKey(2)))
    state = params_from_jax(params, family)
    raw = ("conv1.wc", "conv1.wn") if family == "foutnet" else ("conv1.weight",)
    for key in raw:  # the conv matrices keep their [in, out] layout
        np.testing.assert_array_equal(state[key].numpy(), params["conv1"][key.split(".")[1]])
    np.testing.assert_array_equal(state["fc1.weight"].numpy(), params["fc1"]["w"].T)
    for name in names:
        model = MODELS[name][2](FEAT, 2, 1, device="cpu")
        assert state.keys() == model.state_dict().keys(), name
        model.load_state_dict(state)
        _assert_trees_close(params_to_jax(model.state_dict(), family), params, rtol=0, atol=0)
    # without the family, the raw conv matrices are refused, never transposed
    with pytest.raises(ValueError, match="unexpected parameter"):
        params_from_jax(params)


def test_unported_options_and_unweighted_batches() -> None:
    # compute_dtype: bf16 on the fast models (tests/test_torch_bf16_models.py),
    # none on the COO ones, which have none in the JAX package either
    for cls in (FoutNetDiag, SGATDiag, FoutNetBlockSparse, SGATBlockSparse):
        assert cls(FEAT, 2, 1, device="cpu", compute_dtype=torch.bfloat16).compute_dtype == torch.bfloat16
        with pytest.raises(ValueError, match="compute_dtype"):
            cls(FEAT, 2, 1, device="cpu", compute_dtype=torch.float16)
    for cls in (FoutNet, SGAT):
        with pytest.raises(TypeError, match="compute_dtype"):
            cls(FEAT, 2, 1, device="cpu", compute_dtype=torch.bfloat16)
    for cls in (FoutNetBlockSparse, SGATBlockSparse):
        with pytest.raises(NotImplementedError, match="precision"):
            cls(FEAT, 2, 1, precision="default", device="cpu")
        cls(FEAT, 2, 1, precision="highest", device="cpu")
    entries = ppi_clustered_entries(2, 30, FEAT, seed=3)
    with pytest.raises(ValueError, match="with_edge_weights=True"):
        SGATDiag(FEAT, 2, 1, device="cpu")(tbatch.collate_graphs_diag_clustered(entries, device="cpu")[0])
    with pytest.raises(ValueError, match="with_edge_weights=True"):
        SGATBlockSparse(FEAT, 2, 1, device="cpu")(tbatch.collate_graphs_blocksparse_clustered(entries, device="cpu")[0])
    # no dropout: training mode changes nothing
    _, _, _, model, tb, _ = _setup("sgat_diag", "pure")
    with torch.no_grad():
        assert torch.equal(model(tb, training=True, generator=torch.Generator().manual_seed(0)), model(tb))
