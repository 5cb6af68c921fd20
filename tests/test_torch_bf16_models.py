"""The bf16 models (``compute_dtype=torch.bfloat16``: the five of the first
bf16 slice, then FoutNet and sGAT on the Diag and BCSR paths, sGAT also on
an f32 adjacency) against their JAX twins with ``compute_dtype=jnp.bfloat16`` on the JAX
package's TPU route, its Pallas kernels interpreted on the CPU (on its CPU
route JAX would not run the bf16 kernel forms: the XLA fallbacks ignore
``compute_dtype`` or round other values). One JAX initialization loads into
both (``param_interop``); logits, loss, every gradient and the parameters
after one Adam step are compared, at small sizes.

Tolerances, per model (rtol, and atol as a share of the largest magnitude
of the compared values; the gaps measured on one CPU run are in brackets,
as a share of that magnitude):

- ``GINetClusteredDiag``, ``GINetBlockSparse``, ``GINetClusteredBlockSparse``,
  ``VanillaNetworkBlocked``: bf16 enters only inside the kernels, whose
  rounding points the port copies (tests/test_torch_bf16_kernels.py), so
  both sides differ by f32 summation order only: the f32 tests'
  tolerances, rtol 1e-4 and atol 1e-5 for logits, loss and every gradient
  (logits 5e-7 to 1.4e-6, gradients 1.2e-7 to 3.1e-7).
- ``FoutNetDiag``, ``SGATDiag`` (bf16 adjacency), ``FoutNetBlockSparse``,
  ``SGATBlockSparse`` (bf16 blocks): only K1 or K5 rounds (its input, to
  bf16), after an f32 weight product that torch and XLA may sum in other
  orders, so a rounded input can flip to the neighbouring bf16 value; that
  moves one node's aggregate by a small part of one bf16 step, and the
  pools, the mean and the head dilute it: the kernel-only tolerance holds
  (logits 5e-8 to 1.1e-7, gradients 1.4e-7 to 1.7e-7: no flip at this size).
- ``SGATDiag`` on the f32 adjacency of ``weight_dtype=float32``: JAX's
  kernel never takes a 4-byte adjacency, so it runs its XLA fallback
  (adjacency and x cast to bf16, f32 sums, the aggregate rounded to bf16);
  the port computes that function (ops/diag_spmm.py:_xla_fallback). The
  aggregate's own rounding can flip the same way: the kernel-only tolerance
  (logits 1.8e-7, gradients 1.9e-7).
- ``GINetDense``: its two weight products run in bf16 outside the kernels
  (bf16 out, ``h`` cast to bf16 first, the cotangents rounded to bf16 on
  their way back, as JAX's dot transposes do), and torch's and XLA's CPU
  GEMMs may round an entry to the neighbouring bf16 value (2 of 131,072 in
  a [32, 4096] product on this CPU); such a flip moves what follows by a
  small part of one bf16 step. So rtol 1e-4 and an atol of one bf16 step at
  the largest logit or gradient (2^-7 of it: a bf16 holds 8 significant
  bits; on an H100 one weight gradient entry moved by exactly that against
  the CPU) (logits 2.4e-7, gradients
  2.3e-7: no flip at this size). JAX's own bf16 model is 8.4e-3 (logits)
  and 8.8e-2 (gradients) from its f32 one, outside this bound. The port's
  bf16 model must also stay within JAX's own bf16-vs-f32 bounds
  (tests/test_layer_parity.py): logits within 2e-2 × scale of the f32
  port's, gradients within 4e-2 × scale.
- Control: the port's f32 model misses each model's tolerance against JAX's
  bf16 one, so the bf16 forms really run.
- One Adam step (lr 1e-3, weight decay 1e-5), each package from its own
  gradients: the first step moves a parameter by lr × g / (|g| + eps), lr ×
  sign(g) to 1e-4 wherever |g| > 1e-4 of the largest gradient, so there the
  updated parameters agree at rtol 1e-5 / atol 1e-7 when both gradients
  have one sign; elsewhere (a gradient near 0) within 2 lr.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprank2_tpu.neuralnets.gnn.clustered_blocksparse import FoutNetBlockSparse as JaxFoutNetBlockSparse
from deeprank2_tpu.neuralnets.gnn.clustered_blocksparse import GINetClusteredBlockSparse as JaxGINetClusteredBlockSparse
from deeprank2_tpu.neuralnets.gnn.clustered_blocksparse import SGATBlockSparse as JaxSGATBlockSparse
from deeprank2_tpu.neuralnets.gnn.foutnet import FoutNetDiag as JaxFoutNetDiag
from deeprank2_tpu.neuralnets.gnn.ginet_blocksparse import GINetBlockSparse as JaxGINetBlockSparse
from deeprank2_tpu.neuralnets.gnn.ginet_dense import GINetClusteredDiag as JaxGINetClusteredDiag
from deeprank2_tpu.neuralnets.gnn.ginet_dense import GINetDense as JaxGINetDense
from deeprank2_tpu.neuralnets.gnn.sgat import SGATDiag as JaxSGATDiag
from deeprank2_tpu.neuralnets.gnn.vanilla_gnn import VanillaNetworkBlocked as JaxVanillaNetworkBlocked
from deeprank2_tpu.ops import batch as jbatch
from deeprank2_tpu.ops.losses import CrossEntropyLoss as JaxCrossEntropyLoss
from deeprank2_tpu.ops.optim import Adam as JaxAdam
from deeprank2_tpu_torch.neuralnets.gnn.clustered_blocksparse import FoutNetBlockSparse, GINetClusteredBlockSparse, SGATBlockSparse
from deeprank2_tpu_torch.neuralnets.gnn.foutnet import FoutNetDiag
from deeprank2_tpu_torch.neuralnets.gnn.ginet_blocksparse import GINetBlockSparse
from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetClusteredDiag, GINetDense
from deeprank2_tpu_torch.neuralnets.gnn.sgat import SGATDiag
from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetworkBlocked
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax, params_to_jax
from deeprank2_tpu_torch.ops import batch as tbatch
from deeprank2_tpu_torch.ops import block_sparse as tbs
from deeprank2_tpu_torch.ops import diag_spmm as td
from deeprank2_tpu_torch.ops import vanilla as tv
from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
from deeprank2_tpu_torch.ops.optim import Adam
from deeprank2_tpu_torch.ops.synthetic import clustered_entry, geometric_entry, ppi_clustered_entries, synthetic_entries
from tests.test_torch_bf16_kernels import _interpreted_tpu_route

FEAT = 38
BF16 = torch.bfloat16
LR, WD = 1e-3, 1e-5
# (rtol, atol as a share of the largest magnitude), for logits and loss and for the gradients
KERNEL_ONLY_TOL = (1e-4, 1e-5)
TOLS = {
    "dense": (1e-4, 2.0**-7),
    "clustered_diag": KERNEL_ONLY_TOL,
    "bcsr": KERNEL_ONLY_TOL,
    "clustered_bcsr": KERNEL_ONLY_TOL,
    "blocked": KERNEL_ONLY_TOL,
    "foutnet_diag": KERNEL_ONLY_TOL,
    "sgat_diag": KERNEL_ONLY_TOL,
    "sgat_diag_f32": KERNEL_ONLY_TOL,
    "foutnet_bcsr": KERNEL_ONLY_TOL,
    "sgat_bcsr": KERNEL_ONLY_TOL,
}


def _dense_entries():
    entries = synthetic_entries(5, 24, FEAT, 6, seed=5)
    small = entries[-1]  # a smaller graph: padded nodes inside a real graph
    keep = (small["edge_index"] < 19).all(axis=1)
    entries[-1] = {**small, "x": small["x"][:19], "pos": small["pos"][:19], "edge_index": small["edge_index"][keep]}
    return entries


def _blocked_entries():
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(5)
    out = []
    for g in range(3):
        v = 90 + 7 * g
        pos = rng.uniform(0, 30, size=(v, 3)).astype(np.float32)
        pairs = cKDTree(pos).query_pairs(6.0, output_type="ndarray").astype(np.int64)
        x = rng.normal(size=(v, 10)).astype(np.float32)
        out.append({"x": x, "edge_index": pairs, "edge_attr": rng.normal(size=(len(pairs), 6)).astype(np.float32), "pos": pos, "y": float(g % 2), "entry_name": f"g{g}"})
    return out


def _clustered_bcsr_entries():
    entries = [clustered_entry(n, FEAT, seed=10 + i) for i, n in enumerate((1500, 700, 300))]
    for i, e in enumerate(entries):
        e["entry_name"] = f"c{i}"
    entries[-1]["y"] = None
    return entries


def _geometric_entries():
    entries = [geometric_entry(n, FEAT, 1, seed=i) for i, n in enumerate((700, 1300, 300))]
    entries[-1]["y"] = None
    return entries


def _diag_entries():
    return ppi_clustered_entries(6, 40, FEAT, cell=10.0, seed=1)


# the weighted collates' arguments, by package: bf16 weights (each package's
# default), or f32 ones (the exact-oracle storage)
WEIGHTED = {"jax": {"with_edge_weights": True}, "torch": {"with_edge_weights": True}}
WEIGHTED_F32 = {"jax": {"with_edge_weights": True, "weight_dtype": np.float32}, "torch": {"with_edge_weights": True, "weight_dtype": torch.float32}}
DIAG_KW = {"pad_graphs": 8, "min_slot_nodes": 1}
BCSR_KW = {"pad_graphs": 4, "slot8": True}

# name: (JAX class, port class, (feat, edge feat), parameter family, collate name, its arguments, entries)
# (the arguments are one dict for both packages, or one per package under "jax" and "torch")
MODELS = {
    "dense": (JaxGINetDense, GINetDense, (FEAT, 6), None, "collate_graphs_dense", {"pad_graphs": 8, "pad_nodes": 32}, _dense_entries),
    "clustered_diag": (JaxGINetClusteredDiag, GINetClusteredDiag, (FEAT, 1), None, "collate_graphs_diag_clustered", {"pad_graphs": 8, "min_slot_nodes": 1}, lambda: ppi_clustered_entries(6, 40, FEAT, cell=10.0, seed=1)),
    "bcsr": (JaxGINetBlockSparse, GINetBlockSparse, (FEAT, 1), None, "collate_graphs_blocksparse", {"pad_graphs": 4}, _geometric_entries),
    "clustered_bcsr": (JaxGINetClusteredBlockSparse, GINetClusteredBlockSparse, (FEAT, 1), None, "collate_graphs_blocksparse_clustered", {"pad_graphs": 4, "slot8": True}, _clustered_bcsr_entries),
    "blocked": (JaxVanillaNetworkBlocked, VanillaNetworkBlocked, (10, 6), "vanilla", "collate_graphs_blocked", {"pad_graphs": 4}, _blocked_entries),
    "foutnet_diag": (JaxFoutNetDiag, FoutNetDiag, (FEAT, 1), "foutnet", "collate_graphs_diag_clustered", DIAG_KW, _diag_entries),
    "sgat_diag": (JaxSGATDiag, SGATDiag, (FEAT, 1), "sgat", "collate_graphs_diag_clustered", {k: {**DIAG_KW, **v} for k, v in WEIGHTED.items()}, _diag_entries),
    "sgat_diag_f32": (JaxSGATDiag, SGATDiag, (FEAT, 1), "sgat", "collate_graphs_diag_clustered", {k: {**DIAG_KW, **v} for k, v in WEIGHTED_F32.items()}, _diag_entries),
    "foutnet_bcsr": (JaxFoutNetBlockSparse, FoutNetBlockSparse, (FEAT, 1), "foutnet", "collate_graphs_blocksparse_clustered", BCSR_KW, _clustered_bcsr_entries),
    "sgat_bcsr": (JaxSGATBlockSparse, SGATBlockSparse, (FEAT, 1), "sgat", "collate_graphs_blocksparse_clustered", {k: {**BCSR_KW, **v} for k, v in WEIGHTED.items()}, _clustered_bcsr_entries),
}  # fmt: skip


def _setup(name, compute_dtype=BF16):
    jcls, tcls, (feat, fe), family, collate, kwargs, entries = MODELS[name]
    entries = entries()
    jkw, tkw = (kwargs["jax"], kwargs["torch"]) if "jax" in kwargs else (kwargs, kwargs)
    jb, _ = getattr(jbatch, collate)(entries, **jkw)
    tb, _ = getattr(tbatch, collate)(entries, **tkw, device="cpu")
    jmodel = jcls(feat, 2, fe, compute_dtype=None if compute_dtype is None else jnp.bfloat16)
    model = tcls(feat, 2, fe, compute_dtype=compute_dtype, device="cpu")
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    model.load_state_dict(params_from_jax(params, family=family))
    return jmodel, params, jax.device_put(jb), model, tb, family


def _jax_run(jmodel, params, jb):
    """Logits, loss and gradients of the JAX model on its interpreted TPU
    route (one jitted program each: eager JAX ops dispatched while an
    interpreted kernel's host callbacks still run can deadlock)."""

    def loss(p):
        return JaxCrossEntropyLoss()(jmodel.apply(p, jb), jb.y.astype(jnp.int32), jb.y_mask)

    with _interpreted_tpu_route():
        logits = np.asarray(jax.jit(jmodel.apply)(params, jb))
        value, grads = jax.block_until_ready(jax.jit(jax.value_and_grad(loss))(params))
    return logits, float(value), jax.tree.map(np.asarray, grads)


def _port_run(model, tb, family):
    model.zero_grad()
    logits = model(tb)
    loss = CrossEntropyLoss()(logits, tb.y, tb.y_mask)
    loss.backward()
    grads = params_to_jax({k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in model.named_parameters()}, family=family)
    return logits.detach().numpy(), float(loss.detach()), grads


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v, np.float64)) for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _assert_tree_close(got, want, rtol, atol_share, what):
    scale = max(np.abs(v).max() for _, v in _leaves(want))
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want), strict=True):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol_share * scale, err_msg=f"{what} {path}")


def _misses_tree(got, want, rtol, atol_share) -> bool:
    scale = max(np.abs(v).max() for _, v in _leaves(want))
    return any(np.any(np.abs(a - b) > rtol * np.abs(b) + atol_share * scale) for (_, a), (_, b) in zip(_leaves(got), _leaves(want), strict=True))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_loss_every_gradient_and_one_adam_step_match_jax(name) -> None:
    jmodel, params, jb, model, tb, family = _setup(name)
    rtol, atol_share = TOLS[name]
    want_logits, want_loss, want_grads = _jax_run(jmodel, params, jb)
    for module in (td, tbs, tv):
        module.reset_launches()
    logits, loss, grads = _port_run(model, tb, family)
    # the CPU takes the plain versions, in their bf16 form
    assert not any(v for m in (td, tbs, tv) for v in m.launches.values())
    assert logits.dtype == np.float32 and logits.shape == want_logits.shape
    atol = atol_share * np.abs(want_logits).max()
    np.testing.assert_allclose(logits, want_logits, rtol=rtol, atol=atol)
    np.testing.assert_allclose(loss, want_loss, rtol=rtol, atol=atol_share * abs(want_loss))
    _assert_tree_close(grads, want_grads, rtol, atol_share, "gradient")

    # the control: the port's f32 model is further from JAX's bf16 one
    *_, f32_model, _, _ = _setup(name, compute_dtype=None)
    f32_logits, _, f32_grads = _port_run(f32_model, tb, family)
    assert np.any(np.abs(f32_logits - want_logits) > rtol * np.abs(want_logits) + atol) or _misses_tree(f32_grads, want_grads, rtol, atol_share)

    # one Adam step in each package from its own gradients
    jopt = JaxAdam(lr=LR, weight_decay=WD)
    jparams, _ = jopt.step(params, want_grads, jopt.init(params))
    opt = Adam(model.parameters(), lr=LR, weight_decay=WD)
    opt.step()
    got = _leaves(params_to_jax(model.state_dict(), family=family))
    gscale = max(np.abs(v).max() for _, v in _leaves(want_grads))
    for (path, a), (_, b), (_, g_port), (_, g_jax) in zip(got, _leaves(jparams), _leaves(grads), _leaves(want_grads), strict=True):
        # the step is lr × g / (|g| + eps): lr × sign(g) to 1e-4 where |g| is
        # not tiny, anything up to lr where it is
        settled = (np.abs(g_jax) > 1e-4 * gscale) & (np.sign(g_port) == np.sign(g_jax))
        np.testing.assert_allclose(a[settled], b[settled], rtol=1e-5, atol=1e-7, err_msg=f"Adam step {path}")
        assert np.all(np.abs(a - b)[~settled] <= 2 * LR * (1 + 1e-3)), f"Adam step {path}"


def test_dense_bf16_stays_within_jax_bf16_bounds_of_the_f32_model() -> None:
    """The port's bf16 GINetDense against its f32 one, at JAX's own
    bf16-vs-f32 bounds (tests/test_layer_parity.py): logits within 2e-2 ×
    max(1, max|logits|), the gradients of the summed squared logits within
    4e-2 × max(1, max|g|)."""
    *_, model, tb, _ = _setup("dense")
    *_, f32_model, _, _ = _setup("dense", compute_dtype=None)
    outs, grads = [], []
    for m in (model, f32_model):
        m.zero_grad()
        out = m(tb)
        (out**2).sum().backward()
        outs.append(out.detach().numpy())
        grads.append(np.concatenate([p.grad.flatten().numpy() for p in m.parameters() if p.grad is not None]))
    scale = max(1.0, float(np.abs(outs[1]).max()))
    np.testing.assert_allclose(outs[0], outs[1], atol=2e-2 * scale)
    gscale = max(1.0, float(np.abs(grads[1]).max()))
    np.testing.assert_allclose(grads[0], grads[1], atol=4e-2 * gscale)
    assert not np.array_equal(outs[0], outs[1])  # the bf16 model rounds
