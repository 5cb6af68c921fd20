"""The float64 witness of GINetDense's routes and of K1's int8 f32 form
(deeprank2_tpu_torch/tools/diag_order.py), checked on the CPU at a small
size: every route computes the tower function and passes the per-entry gate
against float64 (tools/f64_gate.py), the routes agree with each other, and
its body switch moves only that form."""

from __future__ import annotations

import pytest
import torch

from deeprank2_tpu_torch.ops import diag_spmm as ds
from deeprank2_tpu_torch.tools import diag_order as do
from deeprank2_tpu_torch.tools import f64_gate as fg


def test_f64_pass_is_the_tower_function() -> None:
    """On the CPU every route is the plain versions: the flat route, the
    fused tower and tower_pooled_ref give the same values, with no relu flip
    against float64, on each seed's batch and on chip_smoke.py's other tower
    batches; each row passes exactly where the c it needs is within the c
    in use, and the c the shipped routes need is the least power of two
    above their largest need."""
    report = do.order_witness(torch.device("cpu"), num_graphs=8, nodes=40, seeds=(7, 8))
    assert (report["graphs"], report["nodes"], report["c_in_use"]) == (8, 40, fg.C)
    assert [b["seed"] for b in report["batches"]] == [7, 8] + [None] * 3 * do.COTANGENTS
    shapes = ["ragged G=9 N=33", "ragged G=7 N=96", "largest supported G=32 N=400"]
    assert [b["batch"] for b in report["batches"][2:]] == [s for s in shapes for _ in range(do.COTANGENTS)]
    for batch in report["batches"]:
        assert set(batch["routes"]) == {"fused", "flat_fma", "flat_mma", "tower_pooled_ref"}
        for row in batch["routes"].values():
            assert row["oracle_masks"] == "float64" and row["share_of_gate"]["pooled"] <= 1.0
            assert set(row["share_of_gate"]) == {"pooled", "dw1", "dw2"}
            assert row["passed"] == (max(row["needed_c"].values()) <= fg.C)
            assert row["flips"]["h1"]["in_band"] == row["flips"]["h1"]["out_of_band"] == 0
            assert row["flips"]["h2"]["in_band"] == row["flips"]["h2"]["out_of_band"] == 0
            assert row["max_abs_err"] == batch["routes"]["fused"]["max_abs_err"]
        for pair in batch["route_vs_route"].values():
            assert all(v == {"max_abs_err": 0.0, "share_of_fixed_gate": 0.0} for v in pair.values())
    # the bench-sized batches need no more than the c in use
    assert all(row["passed"] for b in report["batches"][:2] for row in b["routes"].values())
    needed = report["needed_c"]
    assert set(needed) == {"fused", "flat_fma", "flat_mma", "tower_pooled_ref"}
    shipped = max(needed[r] for r in do.SHIPPED)
    c = report["c_shipped_routes_need"]
    assert c is None if shipped == 0 else c >= shipped > c / 2


@pytest.mark.parametrize("body", ["mma", "fma"])
def test_on_body_moves_only_the_int8_f32_form_of_k1(body) -> None:
    kernels = ("diag_kernel", "pool_bwd_kernel")
    rule = {(k, *form): ds.diag_body(k, *form) for k in kernels for form in ds.FORMS}
    with do.on_body(body):
        for (kernel, adj_dtype, act_dtype), shipped in rule.items():
            moved = kernel == "diag_kernel" and (adj_dtype, act_dtype) == (torch.int8, torch.float32)
            assert ds.diag_body(kernel, adj_dtype, act_dtype) == (body if moved else shipped)
    assert {(k, *form): ds.diag_body(k, *form) for k in kernels for form in ds.FORMS} == rule
