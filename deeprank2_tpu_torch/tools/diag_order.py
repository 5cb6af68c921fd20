"""GINetDense's routes of the tower function against float64, and K1's f32
form on an int8 adjacency on each of its two bodies, on the card.

``ops/diag_spmm.py:diag_body`` runs that form on the tensor cores. Before
it did, the form ran on the FMA body, whose sums go in ascending node order
as the fused tower's do (K9, ``tower_pooled``), because ``chip_smoke.py``
held GINetDense's flat route (K1 and K2) to the fused tower at a fixed atol.
Now every route is held against the function in float64 at the per-entry
gate of ``tools/f64_gate.py``, whose constant ``c`` this script measures.
On the pass of ``chip_smoke.py``'s ``dense_fused_tower`` phase
(GINetDense(38, 2, 6)'s fused weights from torch seed 0, the cotangent from
seed 17) on the bench batch (``synthetic_entries(512, 160, 38, 6)``, seed 7)
and two more seeds of it, it computes the pooled sums and the weight
gradients dw1 and dw2 four ways: the fused tower, the flat route with that
form on the FMA body and on the tensor-core body, and ``tower_pooled_ref``.
The same on ``chip_smoke.py``'s other tower batches (ragged G=9 N=33,
ragged G=7 N=96, 32 graphs at the largest N), three seeded cotangents each.
For each it reports the route's row of the gate (its share of the gate at
the ``c`` in use and of the fixed gate, its largest errors, its relu flips
against float64 and the least ``c`` each output needs), the route-against-
route numbers (largest error and share of the fixed gate), and the least
power of two at which the routes shipped before (the FMA body, and the
fused tower, whose weight gradients were ``tower_pooled_ref``'s) pass on
every batch. It also times the form on both bodies at
the dense and clustered paths' calls, with the L2 flushed before each call.

    python -m deeprank2_tpu_torch.tools.diag_order [--out FILE]

prints one JSON object (and writes it to FILE). Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
from unittest import mock

import torch

from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
from deeprank2_tpu_torch.ops import diag_spmm as ds
from deeprank2_tpu_torch.ops.batch import collate_graphs_dense, collate_graphs_diag_clustered
from deeprank2_tpu_torch.ops.synthetic import ppi_clustered_entries, synthetic_entries
from deeprank2_tpu_torch.tools import f64_gate as fg
from deeprank2_tpu_torch.tools.timing import Timer

SEEDS = (7, 8, 9)  # the bench batch's, and two more
COTANGENTS = 3  # seeded cotangents on each of chip_smoke.py's other tower batches
# the routes shipped before the per-entry gate, on which c is fixed: the
# flat route with K1's int8 f32 form on the FMA body, and the fused tower,
# whose weight gradients were tower_pooled_ref's bit for bit then
SHIPPED = ("tower_pooled_ref", "flat_fma")
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


def flat_masks(adj, mask, x_t, w1, w2):
    """The flat route's relu decisions, ``h1 > 0`` and ``h2 > 0``."""
    h1 = ds.diag_layer_t(adj, mask, w1.T @ x_t)
    sign, _ = ds.diag_kernel(adj, w2.T @ h1, mask, "relu_mask_pool")
    return h1 > 0, sign.bool()


def fused(adj, mask, x_t, a, c):
    return ds.tower_pooled(adj, mask, x_t, a, c)


def fused_masks(adj, mask, x_t, w1, w2):
    h1, sign, _ = ds.tower_fwd_kernel(adj, x_t, mask, w1, w2)
    return h1 > 0, sign.bool()


def ref_masks(adj, mask, x_t, w1, w2):
    h1, sign, _ = ds.tower_fwd_kernel_ref(adj, x_t, mask, w1, w2)
    return h1 > 0, sign.bool()


def ragged_entries(num_graphs: int = 7, nodes: int = 96, feat: int = 38) -> list:
    """Bench-style graphs of decreasing size (seed 3): padded nodes inside
    real graphs."""
    entries = synthetic_entries(num_graphs, nodes, feat, 6, seed=3)
    for i, e in enumerate(entries):
        v = nodes - (9 * i) % (nodes // 2)
        e["x"], e["pos"] = e["x"][:v], e["pos"][:v]
        e["edge_index"] = e["edge_index"][(e["edge_index"] < v).all(axis=1)]
    return entries


def tower_shapes(dev, largest: int) -> list:
    """``chip_smoke.py``'s tower batches beside the bench batch, ``(tag,
    batch)``: ragged G=9 N=33 (off the 16-node tiles and the 32-node bit
    words), ragged G=7 N=96, and 32 graphs at a family's ``largest`` N."""
    return [
        ("ragged G=9 N=33", collate_graphs_dense(ragged_entries(9, 33), pad_nodes=33, device=dev)[0]),
        ("ragged G=7 N=96", collate_graphs_dense(ragged_entries(), pad_nodes=96, device=dev)[0]),
        (f"largest supported G=32 N={largest}", collate_graphs_dense(synthetic_entries(32, largest - 15, 38, 6, seed=9), pad_nodes=largest, device=dev)[0]),
    ]


def run_pass(fn, adj, mask, x_t, w1, w2, g_pool) -> dict:
    """``pooled``, ``dw1`` and ``dw2`` of ``fn`` for the cotangent ``g_pool``."""
    a, c = w1.clone().requires_grad_(True), w2.clone().requires_grad_(True)
    out = fn(adj, mask, x_t, a, c)
    dw1, dw2 = torch.autograd.grad(out, (a, c), g_pool)
    return {"pooled": out.detach(), "dw1": dw1, "dw2": dw2}


def routes(args) -> dict:
    """Each route's outputs and relu decisions on ``args``."""
    out = {"fused": (run_pass(fused, *args), fused_masks(*args[:5]))}
    for body in ("fma", "mma"):
        with on_body(body):
            out[f"flat_{body}"] = (run_pass(flat, *args), flat_masks(*args[:5]))
    out["tower_pooled_ref"] = (run_pass(ds.tower_pooled_ref, *args), ref_masks(*args[:5]))
    return out


def witness(name: str, batch, w1, w2, g_pool) -> dict:
    """Each route on one batch against float64, and the routes against each
    other."""
    args = (batch.adj_i8, batch.node_mask, batch.x_t, w1, w2, g_pool)
    got = routes(args)
    rows = {route: fg.hold_tower(route, outs, args, route_masks=masks, raise_on_fail=False) for route, (outs, masks) in got.items()}
    between = {}
    for a, b in (("flat_fma", "fused"), ("flat_mma", "fused"), ("flat_mma", "flat_fma"), ("tower_pooled_ref", "fused")):
        between[f"{a} vs {b}"] = {
            what: {"max_abs_err": (x.double() - got[b][0][what].double()).abs().max().item(), "share_of_fixed_gate": fg.share(x, got[b][0][what], fg.ATOL)}
            for what, x in got[a][0].items()
        }
    return {"batch": name, "routes": rows, "route_vs_route": between}


def order_witness(dev, num_graphs: int = 512, nodes: int = 160, seeds=SEEDS) -> dict:
    """The routes of the pass against float64 on ``num_graphs`` graphs of
    ``nodes`` nodes for each seed of ``synthetic_entries`` (the bench batch
    and two more by default) and on ``chip_smoke.py``'s other tower batches
    (:func:`tower_shapes`, at the flat tower's largest N) for COTANGENTS
    seeded cotangents each, and the ``c`` they need."""
    w1_t, w2_t = GINetDense(38, 2, 6, device=dev, generator=torch.Generator().manual_seed(0)).fused_weights()
    w1, w2 = w1_t.detach().T.contiguous(), w2_t.detach().T.contiguous()

    def cotangent(g, seed):
        return torch.randn(w2.shape[1], g, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)

    report = {"graphs": num_graphs, "nodes": nodes, "c_in_use": fg.C, "batches": []}
    for seed in seeds:
        batch, _ = collate_graphs_dense(synthetic_entries(num_graphs, nodes, 38, 6, seed=seed), pad_graphs=num_graphs, pad_nodes=nodes, device=dev)
        report["batches"].append({"seed": seed, **witness(f"G={num_graphs} N={nodes} seed {seed}", batch, w1, w2, cotangent(num_graphs, 17))})
    largest = max(n for n in range(1, 1025) if ds.tower_supports(1, n))
    for tag, batch in tower_shapes(dev, largest):
        for k in range(COTANGENTS):
            report["batches"].append({"seed": None, "cotangent_seed": k, **witness(tag, batch, w1, w2, cotangent(batch.adj_i8.shape[0], k))})
    needed = {}
    for b in report["batches"]:
        for name, row in b["routes"].items():
            needed[name] = max(needed.get(name, 0.0), *row["needed_c"].values())
    shipped = max(needed[name] for name in SHIPPED)
    report["needed_c"] = needed
    report["c_shipped_routes_need"] = 2.0 ** math.ceil(math.log2(shipped)) if shipped > 0 else None
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
    report = {"card": card, "gate": order_witness(dev), "times": body_times(dev)}
    text = json.dumps(report)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
