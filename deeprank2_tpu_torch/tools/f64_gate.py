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
