"""The float64 gate of the GINet tower's weight gradients.

GINetDense's flat route (K1 and K2 in ``ops/diag_spmm.py``), the fused flat
tower (``tower_pooled``: K9f and K9b), its plain version
(``tower_pooled_ref``) and the batched tower (K8) compute one function of
``w1 [F, C1]`` and ``w2 [C1, C2]``: per graph, ``h1 = relu(A (w1ᵀ x)) ⊙ m``,
``pooled = Σ_nodes relu(A (w2ᵀ h1)) ⊙ m``, and its weight gradients ``dw1``
and ``dw2`` for a cotangent ``g_pool [C2, G]``. Each route sums in its own
order. Its weight gradients are sums over every node of the batch (81,920 at
the bench shape), whose f32 rounding alone can pass any fixed atol, so each
route is held against the function computed in float64, entry by entry::

    |got - want| <= max(ATOL, c · 2^-24 · S) + RTOL · |want|

with ``S`` the entry's own sum of |products| in float64: the function
evaluated on the absolute values of its inputs (``|x|``, ``|w1|``, ``|w2|``,
``|g_pool|``) with the float64 relu masks, which is every product of every
nested sum that makes the entry, taken once each. Any summation order's f32
error of the entry is a few units of 2^-24 S; ``C`` (a power of two) is the
smallest at which the routes shipped before the tensor cores ran K1's f32
form (K1 on its FMA body, and the fused tower) pass wherever the gate
applies (``tools/diag_order.py`` and ``chip_smoke.py`` report what each
route needs).

A relu whose input lies within its own rounding band of zero may switch
either way in any order (a flip). A flip is allowed only where the input's
float64 value is at most ``c · 2^-24 · S_z``, with ``S_z`` the input's sum of
|terms|; a flip outside that band fails. Where a flip inside the band moves
a weight gradient off the gate, the float64 function is evaluated again with
the route's relu masks, and the route is held against that; the atol never
widens. Logits, loss and pooled sums keep the fixed gate (``ATOL``,
``RTOL``).

The CNNs (``neuralnets/cnn/model3d.py``) are held by the same rule: their
parameters' gradients sum over every voxel of every grid (conv1's weight
gradient 128 x 34·29·29 products an entry at the reference grid protocol).
:func:`cnn_f64` evaluates the network and its gradients in float64 with
relu masks and max-pool winners fixed (float64's or a route's), and the sums
of |products| by the same network on absolute values with those decisions.
A relu flip is held to the band above; a max-pool window whose winner
differs is allowed where float64 puts the two candidates within
``c · 2^-24`` of their sums of |terms|, as a relu flip is. ``C`` was
measured on synthetic grids; on grids mapped from real structures (a
Gaussian over the reference protocol's 1 Å box, nearly constant inside a
pool window) an f32 convolution's outputs sit several units of 2^-24 S from
float64 (up to 15 at conv1 on an H100, 5 on a CPU), so a winner can flip
outside that band. :func:`hold_cnn` then takes, where asked, each
decision's first-order bound instead (:func:`cnn_chain_terms`: ``n · 2^-24
· S`` for the ``n`` products on the chain of sums that makes the input,
Higham's ``γ_n``): a flip inside it is possible in some summation order, and
the gradients are then held, at the unchanged gate, against float64 with
the route's decisions; a flip beyond it fails.

AlignmentGNN's chain holds batch norms and smooth activations, so its
``S`` (:func:`alignment_sums`) takes the backward's own terms: each linear
layer passes ``|g| |W|`` back, an activation ``|f'(z)| |g|``, a batch norm
``|γ|/σ (|g| + mean|g| + |x̂| mean(|g x̂|))`` (the three terms of its
input cotangent, which cancel: the gradient of a bias feeding a batch norm
is 0 in exact arithmetic, its f32 value rounding alone), and each
parameter's gradient sums ``|g|ᵀ |x|`` over the rows, all in float64.
"""

from __future__ import annotations

import dataclasses

import torch

ATOL = 1e-5
RTOL = 1e-4
UNIT = 2.0**-24  # an f32 rounding: half an ulp of 1
# the smallest power of two at which the routes shipped before this gate
# (K1's f32 form on the FMA body, and the fused tower, whose weight
# gradients were tower_pooled_ref's) pass against float64 wherever the gate
# applies, measured on an H100: on the bench batch and two more seeds
# (tools/diag_order.py) they need at most 0.0754 (a relu of layer 1 that
# both flip against float64 at seed 9: 0.0724), on chip_smoke.py's ragged
# G=9 N=33 tower check 0.2406 (dw1); K1's f32 form on the tensor cores
# needs at most 0.0645
C = 0.25


@dataclasses.dataclass
class TowerF64:
    """The tower function in float64 (``pooled``, ``dw1``, ``dw2``), each
    with its sum of |products| (``s_*``); the relu inputs ``z1``, ``z2`` and
    theirs; and the relu masks taken (``m1 = h1 > 0``, ``m2 = h2 > 0``)."""

    pooled: torch.Tensor
    dw1: torch.Tensor
    dw2: torch.Tensor
    s_pooled: torch.Tensor
    s_dw1: torch.Tensor
    s_dw2: torch.Tensor
    z1: torch.Tensor
    z2: torch.Tensor
    s_z1: torch.Tensor
    s_z2: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor


def _agg(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``A u`` per graph: ``a [G, N, N]``, ``u [C, G*N]``."""
    g, n, _ = a.shape
    c = u.shape[0]
    return torch.bmm(a, u.reshape(c, g, n).permute(1, 2, 0)).permute(2, 0, 1).reshape(c, g * n).contiguous()


def layer_f64(adj, x_t, w1) -> tuple[torch.Tensor, torch.Tensor]:
    """The first layer's relu input ``A (w1ᵀ x)`` in float64 and its sum of
    |terms| ``A (|w1|ᵀ |x|)``, ``[C1, G*N]``."""
    a, x, v1 = adj.double(), x_t.double(), w1.double()
    return _agg(a, v1.T @ x), _agg(a.abs(), v1.abs().T @ x.abs())


def tower_f64(adj, mask, x_t, w1, w2, g_pool, g_scale=None, masks=None) -> TowerF64:
    """The tower function and its weight gradients in float64 on ``adj
    [G, N, N]`` (int8 0/1), ``mask [G, N]``, ``x_t [F, G*N]``, ``w1``, ``w2``
    and the cotangent ``g_pool [C2, G]`` (its own sum of |terms|
    ``g_scale``, where it is itself a sum: ``|g_pool|`` by default). With
    ``masks`` (``h1 > 0``, ``h2 > 0`` of a route, bool ``[C, G*N]``) the
    relus take the route's decisions in place of float64's."""
    g, n, _ = adj.shape
    a = adj.double()
    live = mask.reshape(1, g * n)
    x, v2 = x_t.double(), w2.double()
    z1, s_z1 = layer_f64(adj, x_t, w1)
    m1 = ((z1 > 0) & live) if masks is None else masks[0] & live
    h1, s_h1 = z1 * m1, s_z1 * m1
    z2, s_z2 = _agg(a, v2.T @ h1), _agg(a.abs(), v2.abs().T @ s_h1)
    m2 = ((z2 > 0) & live) if masks is None else masks[1] & live
    c2 = w2.shape[1]
    pooled, s_pooled = (z2 * m2).reshape(c2, g, n).sum(2), (s_z2 * m2).reshape(c2, g, n).sum(2)
    gp = g_pool.double()
    sg = gp.abs() if g_scale is None else g_scale.double()
    t2 = _agg(a, m2 * gp.repeat_interleave(n, dim=1))
    s_t2 = _agg(a.abs(), m2 * sg.repeat_interleave(n, dim=1))
    t1 = _agg(a, m1 * (v2 @ t2))
    s_t1 = _agg(a.abs(), m1 * (v2.abs() @ s_t2))
    return TowerF64(pooled, x @ t1.T, h1 @ t2.T, s_pooled, x.abs() @ s_t1.T, s_h1 @ s_t2.T, z1, z2, s_z1, s_z2, m1, m2)


def dense_head_cotangent(pooled, counts, fc1_w, fc1_b, fc2_w) -> tuple[torch.Tensor, torch.Tensor]:
    """GINetDense's head on the pooled sums ``[C2, G]`` (mean over each
    graph's ``counts`` nodes, fc1, relu, fc2) in float64: the cotangent of
    the pooled sums for the sum of the logits, ``[C2, G]``, and its sum of
    |terms| (fc2's bias does not enter it)."""
    mean = pooled.double().T / counts.double()[:, None]
    on = (mean @ fc1_w.double().T + fc1_b.double()) > 0
    ones = torch.ones(mean.shape[0], fc2_w.shape[0], dtype=torch.float64, device=pooled.device)
    g = ((ones @ fc2_w.double()) * on) @ fc1_w.double()
    s = ((ones @ fc2_w.double().abs()) * on) @ fc1_w.double().abs()
    return (g / counts.double()[:, None]).T, (s / counts.double()[:, None]).T


def ginet_dense_grads(dw1: torch.Tensor, dw2: torch.Tensor) -> dict:
    """The fused tower's ``dw1 [F, 32]`` and ``dw2 [32, 64]`` (or their sums
    of |products|) as GINetDense's conv weight gradients, by parameter name
    (``GINetDense.fused_weights``: ``w1ᵀ = [conv1 ; conv1_ext]``,
    ``w2ᵀ = blockdiag(conv2, conv2_ext)``)."""
    h = dw1.shape[1] // 2
    return {
        "conv1.fc.weight": dw1[:, :h].T,
        "conv1_ext.fc.weight": dw1[:, h:].T,
        "conv2.fc.weight": dw2[:h, : dw2.shape[1] // 2].T,
        "conv2_ext.fc.weight": dw2[h:, dw2.shape[1] // 2 :].T,
    }


def gate_atol(s: torch.Tensor) -> torch.Tensor:
    """The per-entry atol: ``max(ATOL, C · 2^-24 · S)``."""
    return torch.clamp(C * UNIT * s.double(), min=ATOL)


def share(got: torch.Tensor, want: torch.Tensor, atol) -> float:
    """The largest share of the allowance ``atol + RTOL |want|`` (``atol`` a
    number or a tensor) that ``got`` uses: above 1 fails."""
    want = want.double()
    err = (got.double() - want).abs()
    return (err / (atol + RTOL * want.abs())).max().item() if err.numel() else 0.0


def needed_c(got: torch.Tensor, want: torch.Tensor, s: torch.Tensor) -> float:
    """The least ``c`` at which ``got`` passes the gate: 0 where the fixed
    allowance (``ATOL + RTOL |want|``) holds every entry."""
    want = want.double()
    err = (got.double() - want).abs()
    over = err > ATOL + RTOL * want.abs()
    if not bool(over.any()):
        return 0.0
    return ((err - RTOL * want.abs())[over] / (UNIT * s.double()[over])).max().item()


def flips(on: torch.Tensor, z: torch.Tensor, s_z: torch.Tensor, live: torch.Tensor) -> dict:
    """The relu decisions of a route (``on``: its output > 0) that differ
    from float64's (``z > 0``) at live nodes: how many lie inside the band
    ``|z| <= C · 2^-24 · S_z`` and how many outside, and the least ``c``
    whose band holds them all."""
    differ = (on.bool() != (z > 0)) & live
    band = z.abs() <= C * UNIT * s_z
    need = (z.abs()[differ] / (UNIT * s_z[differ])).max().item() if bool(differ.any()) else 0.0
    return {"in_band": int((differ & band).sum()), "out_of_band": int((differ & ~band).sum()), "needed_c": need}


def hold(name: str, got: dict, want: dict, scale: dict) -> dict:
    """``got`` against ``want`` (both by output name), ``pooled`` at the
    fixed gate and the rest at the per-entry gate with the sums of
    |products| ``scale``: each output's share of its gate and of the fixed
    gate, its largest error and the least ``c`` it needs."""
    row = {"route": name, "c": C, "max_abs_err": {}, "share_of_gate": {}, "share_of_fixed_gate": {}, "needed_c": {}}
    for what, g in got.items():
        w = want[what]
        row["max_abs_err"][what] = (g.double() - w.double()).abs().max().item() if g.numel() else 0.0
        row["share_of_fixed_gate"][what] = share(g, w, ATOL)
        if what == "pooled":
            row["share_of_gate"][what] = row["share_of_fixed_gate"][what]
        else:
            row["share_of_gate"][what] = share(g, w, gate_atol(scale[what]))
            row["needed_c"][what] = needed_c(g, w, scale[what])
    row["passed"] = all(v <= 1.0 for v in row["share_of_gate"].values())
    return row


def tower_outputs(t: TowerF64) -> tuple[dict, dict]:
    """The outputs a tower route gives (``pooled``, ``dw1``, ``dw2``) and
    their sums of |products|, by name."""
    return {"pooled": t.pooled, "dw1": t.dw1, "dw2": t.dw2}, {"pooled": t.s_pooled, "dw1": t.s_dw1, "dw2": t.s_dw2}


def hold_tower(name: str, got: dict, args, g_scale=None, route_masks=None, pick=tower_outputs, raise_on_fail: bool = True) -> dict:
    """A route's outputs ``got`` (by name: ``pooled``, ``dw1``, ``dw2`` with
    the default ``pick``) against the tower function in float64 on ``args =
    (adj, mask, x_t, w1, w2, g_pool)`` (``g_scale``: see :func:`tower_f64`):
    pooled at the fixed gate, the rest at the per-entry gate. ``pick`` maps
    a :class:`TowerF64` to the outputs and their sums of |products| by the
    names of ``got``. ``route_masks`` (the route's ``h1 > 0`` and
    ``h2 > 0``, where it can show them) are counted against float64's relu
    decisions and held to the band. Raises on a failure unless
    ``raise_on_fail`` is False (the measurement of ``c``); returns the row."""
    exact = tower_f64(*args, g_scale=g_scale)
    live = args[1].reshape(1, -1)
    row_flips = None
    if route_masks is not None:
        row_flips = {"h1": flips(route_masks[0], exact.z1, exact.s_z1, live), "h2": flips(route_masks[1], exact.z2, exact.s_z2, live)}
    row = hold(name, got, *pick(exact))
    in_band = sum(f["in_band"] for f in row_flips.values()) if row_flips else 0
    out_of_band = sum(f["out_of_band"] for f in row_flips.values()) if row_flips else 0
    row["oracle_masks"] = "float64"
    if not row["passed"] and in_band and not out_of_band:
        # a flip inside the band moved an output: the float64 function with
        # the route's relu decisions
        again = hold(name, got, *pick(tower_f64(*args, g_scale=g_scale, masks=route_masks)))
        again["oracle_masks"] = "the route's"
        again["with_float64_masks"] = {k: row[k] for k in ("share_of_gate", "needed_c")}
        row = again
    row["flips"] = row_flips
    if out_of_band:
        row["passed"] = False
    if row_flips:
        row["needed_c"]["flips"] = max(f["needed_c"] for f in row_flips.values())
    if raise_on_fail and not row["passed"]:
        msg = f"{name} against float64: {row}"
        raise AssertionError(msg)
    return row


# ---------------------------------------------------------------------------
# The CNNs (neuralnets/cnn/model3d.py)

CNN_PARAMS = ("convlayer_000", "convlayer_002", "fclayer_000", "fclayer_001")


@dataclasses.dataclass
class CnnDecisions:
    """The CNN's relu masks (``m1``, ``m2`` after the convolutions, ``m3``
    after ``fclayer_000``) and max-pool winners (``i1``, ``i2``: flat
    indices into each channel's volume, as ``max_pool3d`` returns them)."""

    m1: torch.Tensor
    i1: torch.Tensor
    m2: torch.Tensor
    i2: torch.Tensor
    m3: torch.Tensor

    def to(self, device) -> CnnDecisions:
        return CnnDecisions(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


def _take(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``h [N, C, ...]`` at the pool winners ``idx [N, C, ...]``."""
    return h.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)


def _cnn_fixed(p: dict, x: torch.Tensor, d: CnnDecisions) -> tuple[torch.Tensor, tuple]:
    """The CNN with decisions ``d``: linear in each input and parameter.
    Returns the outputs and the relu inputs ``(z1, z2, z3)``."""
    f = torch.nn.functional
    z1 = f.conv3d(x, p["convlayer_000.weight"], p["convlayer_000.bias"])
    z2 = f.conv3d(_take(z1 * d.m1, d.i1), p["convlayer_002.weight"], p["convlayer_002.bias"])
    p2 = _take(z2 * d.m2, d.i2)
    z3 = f.linear(p2.reshape(p2.shape[0], -1), p["fclayer_000.weight"], p["fclayer_000.bias"])
    return f.linear(z3 * d.m3, p["fclayer_001.weight"], p["fclayer_001.bias"]), (z1, z2, z3)


def _decide(p: dict, x: torch.Tensor) -> CnnDecisions:
    """The CNN's decisions on ``x`` with the parameters ``p`` (a state_dict),
    in ``x``'s dtype and on its device, the convolutions without TF32 as
    the model computes them."""
    from deeprank2_tpu_torch.neuralnets.nn import ieee_fp32

    f = torch.nn.functional
    with torch.no_grad(), ieee_fp32():
        z1 = f.conv3d(x, p["convlayer_000.weight"], p["convlayer_000.bias"])
        p1, i1 = f.max_pool3d(torch.relu(z1), 2, 2, return_indices=True)
        z2 = f.conv3d(p1, p["convlayer_002.weight"], p["convlayer_002.bias"])
        p2, i2 = f.max_pool3d(torch.relu(z2), 2, 2, return_indices=True)
        z3 = f.linear(p2.reshape(p2.shape[0], -1), p["fclayer_000.weight"], p["fclayer_000.bias"])
    return CnnDecisions(z1 > 0, i1, z2 > 0, i2, z3 > 0)


def cnn_decisions(model, x: torch.Tensor) -> CnnDecisions:
    """A route's decisions: its model's parameters on its device and dtype
    (``max_pool3d``'s kernel gives the winners its backward routes to)."""
    return _decide(model.state_dict(), x)


@dataclasses.dataclass
class CnnF64:
    """The CNN in float64 under ``decisions``: its outputs, the loss, the
    parameters' gradients and their sums of |products| (by state_dict
    name), and the relu inputs with theirs."""

    logits: torch.Tensor
    loss: torch.Tensor
    grads: dict
    s_grads: dict
    z: tuple
    s_z: tuple
    decisions: CnnDecisions


def cnn_f64(state: dict, x: torch.Tensor, loss, decisions: CnnDecisions | None = None) -> CnnF64:
    """The CNN of ``state`` (a state_dict) on grids ``x`` and the gradients of
    ``loss(logits)`` (a scalar), in float64 on ``x``'s device, with
    float64's decisions or the route's (``decisions``). The sums of
    |products| are the gradients of the network on ``|x|`` and the
    parameters' absolute values, with the same decisions, for the cotangent
    ``|dloss/dlogits|``."""
    dev = x.device
    p = {k: v.detach().to(dev, torch.float64).requires_grad_(True) for k, v in state.items()}
    xd = x.detach().double()
    if decisions is None:
        decisions = _decide(p, xd)
    d = decisions.to(dev)
    logits, z = _cnn_fixed(p, xd, d)
    value = loss(logits)
    g_logits = torch.autograd.grad(value, logits, retain_graph=True)[0]
    grads = dict(zip(p, torch.autograd.grad(logits, list(p.values()), g_logits)))
    pa = {k: v.detach().abs().requires_grad_(True) for k, v in p.items()}
    logits_a, z_a = _cnn_fixed(pa, xd.abs(), d)
    s_grads = dict(zip(pa, torch.autograd.grad(logits_a, list(pa.values()), g_logits.abs())))
    return CnnF64(logits.detach(), value.detach(), grads, s_grads, tuple(t.detach() for t in z), tuple(t.detach() for t in z_a), decisions)


def cnn_flips(route: CnnDecisions, exact: CnnF64) -> dict:
    """The route's relu decisions and pool winners that differ from
    float64's: for each, how many lie inside the band and how many outside,
    and the least ``c`` whose band holds them all. A pool winner's band is
    float64's gap between the two candidates against the sum of their sums
    of |terms|."""
    z1, z2, z3 = exact.z
    s1, s2, s3 = exact.s_z
    d = exact.decisions
    out = {}
    for name, on, z, s_z in (("relu1", route.m1, z1, s1), ("relu2", route.m2, z2, s2), ("relu3", route.m3, z3, s3)):
        out[name] = flips(on.to(z.device), z, s_z, torch.ones((), dtype=torch.bool, device=z.device))
    for name, idx, h, s_h in (("pool1", "i1", z1 * d.m1.to(z1.device), s1), ("pool2", "i2", z2 * d.m2.to(z2.device), s2)):
        got, want = getattr(route, idx).to(h.device), getattr(d, idx).to(h.device)
        differ = got != want
        gap = (_take(h, want) - _take(h, got))[differ]
        scale = (_take(s_h, want) + _take(s_h, got))[differ]
        need = (gap / (UNIT * scale)).max().item() if bool(differ.any()) else 0.0
        band = gap <= C * UNIT * scale
        out[name] = {"in_band": int(band.sum()), "out_of_band": int((~band).sum()), "needed_c": need}
    return out


def cnn_chain_terms(state: dict) -> dict:
    """For each decision of the CNN of ``state`` (a state_dict), the number
    of products on the chain of nested sums that makes its input: conv1's
    window and bias for relu1 and pool1, conv2's added for relu2 and pool2,
    ``fclayer_000``'s for relu3. An f32 evaluation in any order is within
    about ``n · 2^-24 · S`` of float64 (Higham's ``γ_n``, first order)."""
    n1 = state["convlayer_000.weight"][0].numel() + 1
    n2 = n1 + state["convlayer_002.weight"][0].numel() + 1
    n3 = n2 + state["fclayer_000.weight"].shape[1] + 1
    return {"relu1": n1, "pool1": n1, "relu2": n2, "pool2": n2, "relu3": n3}


def hold_cnn(name: str, got: dict, state: dict, x, loss, route: CnnDecisions, raise_on_fail: bool = True, flip_limit: dict | None = None) -> dict:
    """A route's parameter gradients ``got`` (by state_dict name) against
    the CNN in float64 (:func:`cnn_f64`, ``loss`` of the logits) at the
    per-entry gate, the route's
    relu and pool decisions (``route``: :func:`cnn_decisions`) counted
    against float64's and held to their band; where a flip in the band moved
    a gradient off the gate, against float64 with the route's decisions.
    ``flip_limit`` (by decision, a ``c``; :func:`cnn_chain_terms`), where
    given, admits a decision's flips outside the band up to its limit, as
    flips in the band. Raises on a failure unless ``raise_on_fail`` is
    False; returns the row (with float64's logits and loss under
    ``"f64"``)."""
    exact = cnn_f64(state, x, loss)
    row_flips = cnn_flips(route, exact)
    if flip_limit is not None:
        for decision, f in row_flips.items():
            f["limit_c"] = flip_limit[decision]
            if f["out_of_band"] and f["needed_c"] <= flip_limit[decision]:
                f["in_band"], f["out_of_band"], f["within_limit"] = f["in_band"] + f["out_of_band"], 0, f["out_of_band"]
    got = {k: g.to(exact.grads[k].device) for k, g in got.items()}
    row = hold(name, got, exact.grads, exact.s_grads)
    in_band = sum(f["in_band"] for f in row_flips.values())
    out_of_band = sum(f["out_of_band"] for f in row_flips.values())
    row["oracle_decisions"] = "float64"
    if not row["passed"] and in_band and not out_of_band:
        again_exact = cnn_f64(state, x, loss, decisions=route)
        again = hold(name, got, again_exact.grads, again_exact.s_grads)
        again["oracle_decisions"] = "the route's"
        again["with_float64_decisions"] = {k: row[k] for k in ("share_of_gate", "needed_c")}
        row = again
    row["flips"] = row_flips
    row["needed_c"]["flips"] = max(f["needed_c"] for f in row_flips.values())
    if out_of_band:
        row["passed"] = False
    row["f64"] = {"logits": exact.logits, "loss": exact.loss}
    if raise_on_fail and not row["passed"]:
        msg = f"{name} against float64: { {k: v for k, v in row.items() if k != 'f64'} }"
        raise AssertionError(msg)
    return row



def alignment_sums(model, edges, edge_attr, node_attr, g_out, g_att) -> dict:
    """Each parameter gradient's sum of |terms| (by state_dict name) of
    AlignmentGNN (``neuralnets/gnn/alignmentnet.py``, a model in float64) for
    the cotangents ``g_out``, ``g_att`` of its outputs and attention.

    The network is walked twice in step: its float64 values, and a linear
    stand-in whose backward, for the cotangents' absolute values, is the
    sum of |terms| of every value the backward computes (see the module
    docstring): a linear layer passes ``|W|``, an activation its
    ``|f'(z)|``, a batch norm its three terms; each parameter collects
    ``|g|ᵀ |x|`` (weights) and ``Σ |g|`` (biases). The walk's float64
    outputs must be the model's own to float64 rounding (raises
    otherwise)."""
    from deeprank2_tpu_torch.ops.segment import segment_sum

    f = torch.nn.functional
    p = {k: v.detach().double() for k, v in model.state_dict().items()}
    sink = {k: torch.zeros_like(v, requires_grad=True) for k, v in p.items()}

    def lin(name, x, xs):
        w, b = p[f"{name}.weight"], p[f"{name}.bias"]
        return f.linear(x, w, b), f.linear(xs, w.abs()) + f.linear(x.abs(), sink[f"{name}.weight"], sink[f"{name}.bias"])

    def norm(name, x, xs):
        gamma, beta = p[f"{name}.weight"], p[f"{name}.bias"]
        sigma = torch.sqrt(x.var(dim=0, keepdim=True, correction=0) + 1e-5)
        xh = (x - x.mean(dim=0, keepdim=True)) / sigma
        a = xh.abs()
        stand_in = gamma.abs() / sigma * (xs + xs.mean(dim=0, keepdim=True) + a * (a * xs).mean(dim=0, keepdim=True))
        return xh * gamma + beta, stand_in + a * sink[f"{name}.weight"] + sink[f"{name}.bias"]

    def act(x, xs, fn=f.silu):
        z = x.detach().requires_grad_(True)
        with torch.enable_grad():
            y = fn(z)
            (slope,) = torch.autograd.grad(y.sum(), z)
        return y.detach(), xs * slope.abs()

    def mlp(prefix, x, xs, acts):
        for i, last_act in enumerate(acts):
            x, xs = lin(f"{prefix}.{i}", x, xs)
            if last_act:
                x, xs = act(x, xs)
        return x, xs

    ea, na = edge_attr.double(), node_attr.double()
    e, es = norm("preproc_edge_bn0", ea, torch.zeros_like(ea))
    e, es = lin("preproc_edge_mlp.0", e, es)
    e, es = act(*norm("preproc_edge_bn1", e, es))
    e, es = act(*lin("preproc_edge_mlp.1", e, es))
    h, hs = norm("preproc_node_bn0", na, torch.zeros_like(na))
    h, hs = lin("preproc_node_mlp.0", h, hs)
    h, hs = act(*norm("preproc_node_bn1", h, hs))
    h, hs = act(*lin("preproc_node_mlp.1", h, hs))
    row, col = edges[0], edges[1]
    v = h.shape[0]
    for i in range(len(model.layers)):
        name = f"layers.{i}"
        src, dst = row.clamp(0, v - 1), col.clamp(0, v - 1)
        m, ms = mlp(f"{name}.edge_mlp", torch.cat([e, h[src], h[dst]], dim=1), torch.cat([es, hs[src], hs[dst]], dim=1), (True, True))
        summed, summed_s = segment_sum(m, row, v), segment_sum(ms, row, v)
        u, us = norm(f"{name}.node_bn", torch.cat([summed, h], dim=1), torch.cat([summed_s, hs], dim=1))
        u, us = mlp(f"{name}.node_mlp", u, us, (True, True, False))
        h, hs = h + u, hs + us
    last = f"layers.{len(model.layers) - 1}"
    out, out_s = mlp(f"{last}.output_mlp", h, hs, (True, False))
    att, att_s = mlp(f"{last}.attention_mlp", h, hs, (True, False))
    att, att_s = act(att, att_s, torch.sigmoid)
    with torch.no_grad():
        want_out, want_att = model(edges, ea, na)
    # equal up to float64 rounding (index_add on the card sums in no fixed order)
    if not (torch.allclose(out, want_out, rtol=1e-10, atol=1e-12) and torch.allclose(att, want_att, rtol=1e-10, atol=1e-12)):
        msg = "alignment_sums' walk does not compute the model's outputs"
        raise AssertionError(msg)
    total = (out_s * g_out.double().abs()).sum() + (att_s * g_att.double().abs()).sum()
    return dict(zip(sink, torch.autograd.grad(total, list(sink.values()), allow_unused=True)))
