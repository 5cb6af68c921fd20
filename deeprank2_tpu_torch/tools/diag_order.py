"""K1's f32 form on an int8 adjacency on each of its two bodies, on the card.

``ops/diag_spmm.py:diag_body`` runs that form on the FMA body, whose sums go
in ascending node order as the fused tower's do (K9, ``tower_pooled``),
because ``chip_smoke.py`` holds GINetDense's flat route (K1 and K2) to the
fused tower at CROSS_TOL (rtol 1e-4, atol 1e-5). This script asks which of
the two orders is nearer the function. On the pass of ``chip_smoke.py``'s
``dense_fused_tower`` phase (the bench batch, GINetDense(38, 2, 6)'s fused
weights from torch seed 0, the cotangent from seed 17), it computes the
pooled sums and the weight gradients dw1 and dw2 four ways: the fused tower,
the flat route with that form on the FMA body (as shipped) and on the
tensor-core body, and the same function in float64 (dense per-graph
products of the same f32 inputs, autograd). For each it reports the errors
against float64, in absolute terms and as a share of each entry's sum of
|products| (the weight gradient's own sum over the batch), and the CROSS_TOL
gate between each flat route and the fused tower, with the entries that
miss it. It also times the form on both bodies at the dense and clustered
paths' calls, with the L2 flushed before each call.

    python -m deeprank2_tpu_torch.tools.diag_order [--out FILE]

prints one JSON object (and writes it to FILE). Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
from unittest import mock

import torch

from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
from deeprank2_tpu_torch.ops import diag_spmm as ds
from deeprank2_tpu_torch.ops.batch import collate_graphs_dense, collate_graphs_diag_clustered
from deeprank2_tpu_torch.ops.synthetic import ppi_clustered_entries, synthetic_entries
from deeprank2_tpu_torch.tools.timing import Timer

CROSS_TOL = {"rtol": 1e-4, "atol": 1e-5}  # chip_smoke.py's gate between GINetDense's routes
# K1's calls a train step: (batch, adjacency, mode, F)
STEP_CALLS = {
    "dense": [("dense", "adj", "relu_mask", 32), ("dense", "adj", "relu_mask_pool", 64), ("dense", "adj", "plain", 32)],
    "clustered": [
        ("clustered", "adj", "relu_mask", 32),
        ("clustered", "adj", "plain", 32),
        ("clustered", "adj_p", "relu_mask", 64),
        ("clustered", "adj_p", "plain", 64),
    ],
}


@contextlib.contextmanager
def on_body(body: str):
    """K1's f32 form on an int8 adjacency on ``body``; every other form on
    the body ``diag_body`` gives it."""
    rule = ds.diag_body

    def chosen(kernel, adj_dtype, act_dtype):
        if kernel == "diag_kernel" and (adj_dtype, act_dtype) == (torch.int8, torch.float32):
            return body
        return rule(kernel, adj_dtype, act_dtype)

    with mock.patch.object(ds, "diag_body", chosen):
        yield


def flat(adj, mask, x_t, a, c):
    """GINetDense's flat route of the fused tower: two K1 layers, the second
    pooled, the VJPs through K1 and K2."""
    return ds.diag_layer_pool_t(adj, mask, c.T @ ds.diag_layer_t(adj, mask, a.T @ x_t))


def fused(adj, mask, x_t, a, c):
    return ds.tower_pooled(adj, mask, x_t, a, c)


def run_pass(fn, adj, mask, x_t, w1, w2, g_pool):
    """``(pooled, dw1, dw2)`` of ``fn`` for the cotangent ``g_pool``."""
    a, c = w1.clone().requires_grad_(True), w2.clone().requires_grad_(True)
    out = fn(adj, mask, x_t, a, c)
    return (out.detach(), *torch.autograd.grad(out, (a, c), g_pool))


def f64_pass(adj, mask, x_t, w1, w2, g_pool):
    """The same function in float64, with plain dense products: ``(pooled,
    dw1, dw2)`` and the sums of |products| of dw1 and dw2."""
    g, n, _ = adj.shape
    a_dense = adj.double()
    m = mask.reshape(1, g * n).double()

    def agg(u_t):
        f = u_t.shape[0]
        u = u_t.reshape(f, g, n).permute(1, 2, 0)
        return torch.bmm(a_dense, u).permute(2, 0, 1).reshape(f, g * n)

    a, c = w1.double().requires_grad_(True), w2.double().requires_grad_(True)
    x = x_t.double()
    fcx1 = a.T @ x
    fcx1.retain_grad()
    h1 = torch.relu(agg(fcx1)) * m
    fcx2 = c.T @ h1
    fcx2.retain_grad()
    pooled = (torch.relu(agg(fcx2)) * m).reshape(-1, g, n).sum(2)
    pooled.backward(g_pool.double())
    terms1 = x.abs() @ fcx1.grad.abs().T
    terms2 = h1.detach().abs() @ fcx2.grad.abs().T
    return (pooled.detach(), a.grad, c.grad), (None, terms1, terms2)


def gate_ratio(got, want, atol):
    """The largest share of the CROSS_TOL allowance (rtol 1e-4, ``atol``) that
    ``got`` uses against ``want``: above 1 fails."""
    return ((got - want).abs() / (atol + CROSS_TOL["rtol"] * want.abs())).max().item()


def order_witness(dev, num_graphs: int = 512, nodes: int = 160) -> dict:
    """The four ways of the pass, on ``num_graphs`` bench graphs of ``nodes``
    nodes (the bench batch by default)."""
    entries = synthetic_entries(num_graphs, nodes, 38, 6, seed=7)
    batch, _ = collate_graphs_dense(entries, pad_graphs=num_graphs, pad_nodes=nodes, device=dev)
    w1_t, w2_t = GINetDense(38, 2, 6, device=dev, generator=torch.Generator().manual_seed(0)).fused_weights()
    w1, w2 = w1_t.detach().T.contiguous(), w2_t.detach().T.contiguous()
    gen = torch.Generator(device=dev).manual_seed(17)
    g_pool = torch.randn(w2.shape[1], batch.x.shape[0], generator=gen, device=dev)
    args = (batch.adj_i8, batch.node_mask, batch.x_t, w1, w2, g_pool)
    routes = {"fused": run_pass(fused, *args)}
    for body in ("fma", "mma"):
        with on_body(body):
            routes[f"flat_{body}"] = run_pass(flat, *args)
    exact, terms = f64_pass(*args)
    v = batch.adj_i8.shape[0] * batch.adj_i8.shape[1]
    report = {"nodes": v, "quantities": {}}
    for k, what in enumerate(("pooled", "dw1", "dw2")):
        want = exact[k]
        q = {}
        for name, got in routes.items():
            err = (got[k].double() - want).abs()
            row = {
                "max_abs_err_vs_f64": err.max().item(),
                "off_cross_tol_vs_f64": int((err > CROSS_TOL["atol"] + CROSS_TOL["rtol"] * want.abs()).sum()),
            }
            if terms[k] is not None:
                row["max_err_over_sum_abs_products"] = (err / terms[k].clamp_min(1e-300)).max().item()
            q[name] = row
        ref = routes["fused"][k].double()
        for body in ("fma", "mma"):
            got = routes[f"flat_{body}"][k].double()
            q[f"flat_{body}_vs_fused_cross_tol_ratio"] = gate_ratio(got, ref, CROSS_TOL["atol"])
            if terms[k] is not None:
                # a gate that scales with the sum: atol max(1e-5, 2^-24 sqrt(V) sum|products|)
                rederived = torch.clamp(2.0**-24 * v**0.5 * terms[k], min=CROSS_TOL["atol"])
                q[f"flat_{body}_vs_fused_rederived_ratio"] = gate_ratio(got, ref, rederived)
        if terms[k] is not None:
            diff = (routes["flat_mma"][k].double() - ref).abs() / (CROSS_TOL["atol"] + CROSS_TOL["rtol"] * ref.abs())
            worst = torch.topk(diff.flatten(), 6).indices
            q["worst_flat_mma_vs_fused"] = [
                {
                    "index": [int(i) // want.shape[1], int(i) % want.shape[1]],
                    "cross_tol_ratio": diff.flatten()[i].item(),
                    "f64": want.flatten()[i].item(),
                    "fused": routes["fused"][k].flatten()[i].item(),
                    "flat_fma": routes["flat_fma"][k].flatten()[i].item(),
                    "flat_mma": routes["flat_mma"][k].flatten()[i].item(),
                    "sum_abs_products": terms[k].flatten()[i].item(),
                }
                for i in worst.tolist()
            ]
        report["quantities"][what] = q
    return report


def body_times(dev) -> dict:
    dense, _ = collate_graphs_dense(synthetic_entries(512, 160, 38, 6, seed=7), pad_graphs=512, pad_nodes=160, device=dev)
    clustered, _ = collate_graphs_diag_clustered(ppi_clustered_entries(512, 160, 38, seed=0), device=dev)
    adjs = {
        ("dense", "adj"): (dense.adj_i8, dense.node_mask),
        ("clustered", "adj"): (clustered.adj_i8, clustered.node_mask),
        ("clustered", "adj_p"): (clustered.adj_p_i8, clustered.pooled_mask),
    }
    timer = Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for path, calls in STEP_CALLS.items():
        rows, step = [], {"fma": 0.0, "mma": 0.0, "bmm": 0.0}
        for name, which, mode, f in calls:
            adj, mask = adjs[(name, which)]
            g, n, _ = adj.shape
            x = torch.randn(f, g * n, generator=gen, device=dev)
            m = None if mode == "plain" else mask
            row = {"shape": [g, n, n], "mode": mode, "F": f}
            want = ds.diag_kernel_ref(adj, x, m, mode)
            for body in ("fma", "mma"):
                with on_body(body):
                    got = ds.diag_kernel(adj, x, m, mode)
                    pairs = zip(got, want) if mode == "relu_mask_pool" else [(got, want)]
                    row[f"{body}_max_abs_err"] = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
                    row[f"{body}_ms"] = timer.ms(lambda: ds.diag_kernel(adj, x, m, mode))
                step[body] += row[f"{body}_ms"]
            adj_f, x_gnf = adj.float(), x.reshape(f, g, n).permute(1, 2, 0).contiguous()
            row["bmm_ms"] = timer.ms(lambda: torch.bmm(adj_f, x_gnf))
            step["bmm"] += row["bmm_ms"]
            rows.append(row)
        out[path] = {"calls": rows, "step_ms": step}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON object to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=False
    ).stdout.strip()
    report = {"card": card, "witness": order_witness(dev), "times": body_times(dev)}
    text = json.dumps(report)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
