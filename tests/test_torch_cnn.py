"""The port's 3D CNNs (deeprank2_tpu_torch/neuralnets/cnn/model3d.py) against
the JAX package's (deeprank2_tpu/neuralnets/cnn/model3d.py) on the CPU.

- Both CNNs on a 10x10x10 box with 3 features and a ragged 7x9x11 box with 5
  features, from the JAX initialization carried across by
  ``params_from_jax(..., "cnn")``: logits at rtol 1e-5, atol 1e-6; every
  parameter's gradient, the port's and JAX's, against the network in
  float64 at the per-entry gate of ``tools/f64_gate.py``.
- Grids with an all-zero shell (mapped features vanish far from atoms) and
  positive conv biases, whose pooling windows tie: the same comparisons, so
  the gradients that depend on which element wins a window.
- The ``"cnn"`` family: JAX parameters to the port and back bit for bit,
  and a state_dict under the reference's names (a torch mirror of the
  reference module) loads into the port with the same outputs, and into the
  JAX package through its own ``torch_interop``.

Every input comes from a seeded numpy generator.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprank2_tpu.neuralnets.cnn import model3d as jax_model3d
from deeprank2_tpu.neuralnets.torch_interop import translate_state_dict
from deeprank2_tpu.ops import losses as jax_losses
from deeprank2_tpu.ops.batch import GridBatch as JaxGridBatch
from deeprank2_tpu_torch.neuralnets.cnn import model3d
from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax, params_to_jax
from deeprank2_tpu_torch.ops import losses
from deeprank2_tpu_torch.ops.batch import GridBatch, collate_grids
from deeprank2_tpu_torch.ops.synthetic import grid_arrays, grid_entries, zero_shell
from deeprank2_tpu_torch.tools import f64_gate as fg

LOGIT_TOL = {"rtol": 1e-5, "atol": 1e-6}
# case -> (features, box)
BOXES = {"cube10": (3, (10, 10, 10)), "ragged7x9x11": (5, (7, 9, 11))}
MODELS = {
    "CnnClassification": (jax_model3d.CnnClassification, model3d.CnnClassification, losses.CrossEntropyLoss, jax_losses.CrossEntropyLoss),
    "CnnRegression": (jax_model3d.CnnRegression, model3d.CnnRegression, losses.MSELoss, jax_losses.MSELoss),
}


def _pair(model: str, features: int, box: tuple, seed: int = 0, positive_bias: bool = False):
    """The JAX model and its parameters, and the port's model holding them."""
    jax_cls, port_cls, _, _ = MODELS[model]
    jm = jax_cls(features, box)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    if positive_bias:  # every zero-shell window of either conv then ties at a positive value
        for conv in ("conv000", "conv002"):
            params[conv]["b"] = np.abs(params[conv]["b"]) + np.float32(0.05)
    pm = port_cls(features, box, device="cpu")
    pm.load_state_dict(params_from_jax(params, "cnn"))
    return jm, params, pm


def _batch(features: int, box: tuple, n: int = 6, seed: int = 1, shell: int = 0):
    x, y = grid_arrays(n, features, box, seed=seed)
    if shell:
        x = zero_shell(x, shell)
    batch, names = collate_grids(grid_entries(x, y), pad_graphs=n + 1, device="cpu")
    assert names[-1] == "" and not bool(batch.y_mask[-1])
    jb = JaxGridBatch(x=jnp.asarray(batch.x.numpy()), y=jnp.asarray(batch.y.numpy()), y_mask=jnp.asarray(batch.y_mask.numpy()))
    return batch, jb


def _check(model: str, features: int, box: tuple, shell: int = 0, positive_bias: bool = False) -> dict:
    jm, params, pm = _pair(model, features, box, positive_bias=positive_bias)
    batch, jb = _batch(features, box, shell=shell)
    _, _, port_loss_cls, jax_loss_cls = MODELS[model]
    port_loss, jax_loss = port_loss_cls(), jax_loss_cls()

    def jax_objective(p):
        out = jm.apply(p, jb)
        pred = out if model == "CnnClassification" else out.reshape(-1)
        return jax_loss(pred, jb.y, jb.y_mask), out

    (_, jax_logits), jax_grads = jax.value_and_grad(jax_objective, has_aux=True)(jax.tree.map(jnp.asarray, params))

    def loss_of(logits):
        return port_loss(logits if model == "CnnClassification" else logits.reshape(-1), batch.y, batch.y_mask)

    logits = pm(batch)
    loss_of(logits).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jax_logits), **LOGIT_TOL)

    port_grads = {k: p.grad for k, p in pm.named_parameters()}
    jax_state = params_from_jax(jax.tree.map(np.asarray, jax_grads), "cnn")
    route = fg.cnn_decisions(pm, batch.x)
    rows = {
        "port": fg.hold_cnn("port", port_grads, pm.state_dict(), batch.x, loss_of, route),
        "jax": fg.hold_cnn("jax", jax_state, pm.state_dict(), batch.x, loss_of, route),
    }
    np.testing.assert_allclose(logits.detach().double().numpy(), rows["port"]["f64"]["logits"].numpy(), **LOGIT_TOL)
    return rows


@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_cnn_matches_jax(model, box) -> None:
    features, shape = BOXES[box]
    rows = _check(model, features, shape)
    assert all(r["passed"] for r in rows.values())


@pytest.mark.parametrize("model", sorted(MODELS))
def test_cnn_matches_jax_on_tied_pooling_windows(model) -> None:
    """Zero-shell grids: the first conv gives its (positive) bias over the
    whole shell, so its pooling windows tie; so do the second conv's, whose
    inputs are then constant per channel. Both sides send a tied window's
    cotangent to its first maximum, as float64 does."""
    features, box = 3, (12, 12, 12)
    rows = _check(model, features, box, shell=3, positive_bias=True)
    assert all(r["passed"] and r["oracle_decisions"] == "float64" for r in rows.values())
    _, _, pm = _pair(model, features, box, positive_bias=True)
    batch, _ = _batch(features, box, shell=3)
    with torch.no_grad():
        h1 = torch.relu(torch.nn.functional.conv3d(batch.x, pm.convlayer_000.weight, pm.convlayer_000.bias))
    windows = h1[:, :, :10, :10, :10].reshape(*h1.shape[:2], 5, 2, 5, 2, 5, 2).permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(-1, 8)
    tied = (windows == windows.max(dim=1, keepdim=True).values).sum(dim=1) > 1
    assert int(tied.sum()) > 1000  # the shell's windows tie, at the bias


def test_cnn_family_round_trips_bit_for_bit() -> None:
    for model in MODELS:
        _, params, pm = _pair(model, 5, (7, 9, 11), seed=3)
        back = params_to_jax(pm.state_dict(), "cnn")
        got, want = jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves_with_path(params)
        assert len(got) == len(want) == 8
        for (pa, a), (pb, b) in zip(got, want):
            assert pa == pb and a.dtype == b.dtype and np.array_equal(a, b), pa


class _ReferenceCnn(torch.nn.Module):
    """The reference's CnnClassification module as written
    (neuralnets/cnn/model3d.py of deeprank2): its parameter names and its
    pools as modules between the convs."""

    def __init__(self, num_features: int, flat: int):
        super().__init__()
        self.convlayer_000 = torch.nn.Conv3d(num_features, 4, kernel_size=2)
        self.convlayer_001 = torch.nn.MaxPool3d((2, 2, 2))
        self.convlayer_002 = torch.nn.Conv3d(4, 5, kernel_size=2)
        self.convlayer_003 = torch.nn.MaxPool3d((2, 2, 2))
        self.fclayer_000 = torch.nn.Linear(flat, 84)
        self.fclayer_001 = torch.nn.Linear(84, 2)

    def forward(self, x):
        x = self.convlayer_001(torch.relu(self.convlayer_000(x)))
        x = self.convlayer_003(torch.relu(self.convlayer_002(x)))
        return self.fclayer_001(torch.relu(self.fclayer_000(x.view(x.shape[0], -1))))


def test_reference_named_state_dict_loads() -> None:
    features, box = 5, (7, 9, 11)
    port = model3d.CnnClassification(features, box, device="cpu")
    torch.manual_seed(0)
    ref = _ReferenceCnn(features, port.flat_size)
    state = ref.state_dict()
    assert set(state) == set(port.state_dict())
    port.load_state_dict(state)
    batch, jb = _batch(features, box)
    with torch.no_grad():
        np.testing.assert_allclose(port(batch).numpy(), ref(batch.x).numpy(), rtol=0, atol=1e-6)
    # the JAX package reads the same names, into the tree the port maps
    jax_tree = translate_state_dict("CnnClassification", {k: v.numpy() for k, v in state.items()})
    ours = params_to_jax(state, "cnn")
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(ours), jax.tree_util.tree_leaves_with_path(jax_tree)):
        assert pa == pb and np.array_equal(a, b)
    jax_logits = jax_model3d.CnnClassification(features, box).apply(jax.tree.map(jnp.asarray, jax_tree), jb)
    np.testing.assert_allclose(ref(batch.x).detach().numpy(), np.asarray(jax_logits), **LOGIT_TOL)


def test_collate_grids_matches_jax() -> None:
    from deeprank2_tpu.ops.batch import collate_grids as jax_collate_grids

    x, y = grid_arrays(3, 2, (4, 5, 6), seed=4)
    entries = grid_entries(x, y)
    entries[1]["y"] = None
    got, names = collate_grids(entries, pad_graphs=5, device="cpu")
    want, jax_names = jax_collate_grids(entries, pad_graphs=5)
    assert names == jax_names == ["grid_0", "grid_1", "grid_2", "", ""]
    for field in ("x", "y", "y_mask"):
        assert np.array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field))), field
    assert got.num_graphs == 5 and got.to("cpu").x.shape == (5, 2, 4, 5, 6)
    with pytest.raises(ValueError, match="pad_graphs"):
        collate_grids(entries, pad_graphs=2, device="cpu")


def test_cnn_f64_gate_holds_flips_to_their_band() -> None:
    """tools/f64_gate.py on the CNN: float64's gradients are autograd's of
    the model in float64, each |gradient| is within its sum of |products|;
    a route whose pool winner differs from float64's in a tied window (a
    flip in the band) is held against float64 with its own decisions and
    passes, a route that picks a lesser element fails, and so does an error
    of four times the gate."""
    features, box = 3, (12, 12, 12)
    _, _, pm = _pair("CnnClassification", features, box, positive_bias=True)
    batch, _ = _batch(features, box, shell=3)
    ce = losses.CrossEntropyLoss()

    def loss_of(logits):
        return ce(logits, batch.y, batch.y_mask)

    exact = fg.cnn_f64(pm.state_dict(), batch.x, loss_of)
    m64 = model3d.CnnClassification(features, box, device="cpu").double()
    m64.load_state_dict(pm.state_dict())
    loss_of(m64(GridBatch(batch.x.double(), batch.y, batch.y_mask))).backward()
    for name, p in m64.named_parameters():
        torch.testing.assert_close(exact.grads[name], p.grad, rtol=1e-12, atol=1e-14)
        assert bool((exact.s_grads[name] >= p.grad.abs() * (1 - 1e-12)).all()), name

    # a tied window of the shell (grid 0, channel 0, the first window): its
    # second element wins on the route
    d = exact.decisions
    i1 = d.i1.clone()
    assert float(exact.z[0][0, 0, 0, 0, 0]) == float(exact.z[0][0, 0, 0, 0, 1]) > 0
    i1[0, 0, 0, 0, 0] = 1
    tied = fg.CnnDecisions(d.m1, i1, d.m2, d.i2, d.m3)
    got = fg.cnn_f64(pm.state_dict(), batch.x, loss_of, decisions=tied).grads
    row = fg.hold_cnn("tied flip", got, pm.state_dict(), batch.x, loss_of, tied)
    assert row["passed"] and row["flips"]["pool1"] == {"in_band": 1, "out_of_band": 0, "needed_c": 0.0}

    # a window whose winner is strictly larger: a lesser element is no flip
    z1 = exact.z[0] * d.m1  # [N, 4, 11, 11, 11]
    windows = z1[:, :, :10, :10, :10].reshape(-1, 4, 5, 2, 5, 2, 5, 2).permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(*z1.shape[:2], 5, 5, 5, 8)
    top2 = windows.topk(2, dim=-1).values
    n, c, a, b, cc = (int(i) for i in torch.nonzero(top2[..., 0] > top2[..., 1] + 1e-3)[0])
    winner = int(d.i1[n, c, a, b, cc])
    others = [((2 * a + da) * 11 + 2 * b + db) * 11 + 2 * cc + dc for da in (0, 1) for db in (0, 1) for dc in (0, 1)]
    wrong = fg.CnnDecisions(d.m1, d.i1.clone(), d.m2, d.i2, d.m3)
    wrong.i1[n, c, a, b, cc] = next(i for i in others if i != winner)
    row = fg.hold_cnn("lesser winner", exact.grads, pm.state_dict(), batch.x, loss_of, wrong, raise_on_fail=False)
    assert not row["passed"] and row["flips"]["pool1"]["out_of_band"] == 1

    off = {k: v + 4 * fg.gate_atol(exact.s_grads[k]) for k, v in exact.grads.items()}
    with pytest.raises(AssertionError, match="against float64"):
        fg.hold_cnn("off", off, pm.state_dict(), batch.x, loss_of, fg.cnn_decisions(pm, batch.x))


def test_f64_gate_flip_limit_admits_only_flips_within_their_chains_bound() -> None:
    """``cnn_chain_terms`` counts each decision's chain of products; with
    ``hold_cnn(..., flip_limit=...)`` a pool winner outside the band C is
    admitted up to its decision's limit (and the gradients held against
    float64 with the route's decisions), and fails beyond it; without a
    limit the gate is as before."""
    features, box = 3, (12, 12, 12)
    _, _, pm = _pair("CnnClassification", features, box, positive_bias=True)
    batch, _ = _batch(features, box)
    ce = losses.CrossEntropyLoss()

    def loss_of(logits):
        return ce(logits, batch.y, batch.y_mask)

    state = pm.state_dict()
    limits = fg.cnn_chain_terms(state)
    w1, w2, w3 = state["convlayer_000.weight"], state["convlayer_002.weight"], state["fclayer_000.weight"]
    # a conv output sums in-channels x the kernel's voxels, and its bias
    n1 = features * w1[0, 0].numel() + 1
    n2 = n1 + w2.shape[1] * w2[0, 0].numel() + 1
    assert limits == {"relu1": n1, "pool1": n1, "relu2": n2, "pool2": n2, "relu3": n2 + w3.shape[1] + 1}
    assert w1.shape[1] == features
    exact = fg.cnn_f64(state, batch.x, loss_of)
    d = exact.decisions
    h, s = exact.z[0] * d.m1, exact.s_z[0]
    flat_h, flat_s = h.flatten(2), s.flatten(2)
    win = d.i1.flatten(2)
    # each window's runner-up: the largest element other than the winner
    n1, c1, *dims = h.shape
    cut = tuple(x // 2 * 2 for x in dims)
    idx = torch.arange(flat_h.shape[2]).view(dims)[: cut[0], : cut[1], : cut[2]]
    windows = idx.reshape(cut[0] // 2, 2, cut[1] // 2, 2, cut[2] // 2, 2).permute(0, 2, 4, 1, 3, 5).reshape(-1, 8)
    vals = flat_h[:, :, windows]  # [N, C, windows, 8]
    order = vals.argsort(dim=-1, descending=True)
    second = windows[torch.arange(windows.shape[0])[None, None, :], order[..., 1]]
    gap = fg._take(h, d.i1).flatten(2) - flat_h.gather(2, second)
    need = gap / (fg.UNIT * (fg._take(s, d.i1).flatten(2) + flat_s.gather(2, second)))
    # the window whose runner-up float64 puts closest to the winner outside the band
    need = torch.where(need > fg.C, need, torch.full_like(need, float("inf")))
    g, c, w = (int(v) for v in torch.nonzero(need == need.min())[0])
    least = float(need[g, c, w])
    assert fg.C < least < float("inf")
    route = fg.CnnDecisions(d.m1, d.i1.clone(), d.m2, d.i2, d.m3)
    route.i1.view(n1, c1, -1)[g, c, w] = second[g, c, w]
    got = fg.cnn_f64(state, batch.x, loss_of, decisions=route).grads
    plain = fg.hold_cnn("flip", got, state, batch.x, loss_of, route, raise_on_fail=False)
    assert not plain["passed"] and plain["flips"]["pool1"]["out_of_band"] == 1
    for limit, admitted in ((least * 1.01, True), (least * 0.99, False)):
        row = fg.hold_cnn("flip", got, state, batch.x, loss_of, route, raise_on_fail=False, flip_limit={**limits, "pool1": limit})
        assert row["passed"] == admitted
        assert row["flips"]["pool1"]["out_of_band"] == (0 if admitted else 1)
        assert row["flips"]["pool1"]["limit_c"] == limit
