"""The order witness of K1's int8 f32 form
(deeprank2_tpu_torch/tools/diag_order.py), checked on the CPU at a small
size: its float64 pass computes the function of GINetDense's flat route and
fused tower, and its body switch moves only that form."""

from __future__ import annotations

import pytest
import torch

from deeprank2_tpu_torch.ops import diag_spmm as ds
from deeprank2_tpu_torch.tools import diag_order as do


def test_f64_pass_is_the_tower_function() -> None:
    """On the CPU every route is the plain versions: the flat route and the
    fused tower agree with each other, and with the float64 pass to f32
    rounding (rtol 1e-4, atol 1e-5 of each quantity's largest magnitude)."""
    report = do.order_witness(torch.device("cpu"), num_graphs=8, nodes=40)
    assert report["nodes"] == 8 * 40
    for what, q in report["quantities"].items():
        assert q["flat_fma_vs_fused_cross_tol_ratio"] == q["flat_mma_vs_fused_cross_tol_ratio"] == 0.0
        for route in ("fused", "flat_fma", "flat_mma"):
            assert q[route]["max_abs_err_vs_f64"] == q["fused"]["max_abs_err_vs_f64"]
            if what != "pooled":
                assert q[route]["max_err_over_sum_abs_products"] < 1e-5
        if what != "pooled":
            worst = q["worst_flat_mma_vs_fused"]
            assert len(worst) == 6
            for row in worst:
                scale = max(abs(r["f64"]) for r in worst)
                assert abs(row["fused"] - row["f64"]) <= 1e-5 * scale + 1e-4 * abs(row["f64"])
    assert report["quantities"]["pooled"]["fused"]["off_cross_tol_vs_f64"] == 0


@pytest.mark.parametrize("body", ["mma", "fma"])
def test_on_body_moves_only_the_int8_f32_form_of_k1(body) -> None:
    kernels = ("diag_kernel", "pool_bwd_kernel")
    rule = {(k, *form): ds.diag_body(k, *form) for k in kernels for form in ds.FORMS}
    with do.on_body(body):
        for (kernel, adj_dtype, act_dtype), shipped in rule.items():
            moved = kernel == "diag_kernel" and (adj_dtype, act_dtype) == (torch.int8, torch.float32)
            assert ds.diag_body(kernel, adj_dtype, act_dtype) == (body if moved else shipped)
    assert {(k, *form): ds.diag_body(k, *form) for k in kernels for form in ds.FORMS} == rule
