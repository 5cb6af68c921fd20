"""K9f's summation order as a plain loop (deeprank2_tpu_torch/ops/diag_spmm.py:
``tower_fwd_order_ref``, with ``fma_f32``, CUDA's ``fmaf`` in float64), on
the CPU: the card tests hold the kernel's h1 and sign to it bit for bit.

- ``fma_f32`` rounds ``a * b + c`` once, as exact rational arithmetic does,
  also where rounding the float64 sum again would land on the other side of
  a float32 midpoint.
- The loop is the JAX package's tower forward (``_tower_ref``: h1, and the
  sign of h2 wherever h2 is clear of zero) and the port's plain version, in
  both forms.

Every input comes from a seeded numpy generator.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import pytest
import torch

from deeprank2_tpu.ops import diag_spmm as jd
from deeprank2_tpu_torch.ops import diag_spmm as td

FWD_TOL = {"rtol": 1e-5, "atol": 1e-4}  # tests/utils/test_pallas_ginet.py:45


def _fma_exact(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """``a * b + c`` rounded once to float32 (nearest, ties to even), from the
    exact rational value."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x), int(np.float32(v).view(np.uint32)) & 1))


def test_fma_f32_rounds_once() -> None:
    rng = np.random.default_rng(5)
    a = rng.normal(size=3000).astype(np.float32)
    b = rng.normal(size=3000).astype(np.float32)
    c = (rng.normal(size=3000) * np.exp(8 * rng.normal(size=3000))).astype(np.float32)
    # where the float64 sum is a float32 midpoint and its dropped bits pick
    # the side: (1 + 2^-23)(2^-24 - 2^-47) + (1 + 2^-23) is just below the
    # midpoint 1 + 2^-23 + 2^-24, which rounding twice sends up to even
    edge = np.float32(1 + 2**-23), np.float32(2**-24 - 2**-47)
    a = np.concatenate([a, [edge[0], -edge[0], edge[0]]]).astype(np.float32)
    b = np.concatenate([b, [edge[1], edge[1], 2**-24 + 2**-47]]).astype(np.float32)
    c = np.concatenate([c, [edge[0], -edge[0], 1.0]]).astype(np.float32)
    got = td.fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    twice = (torch.from_numpy(a).double() * torch.from_numpy(b).double() + torch.from_numpy(c).double()).float().numpy()
    assert got[-3] == np.float32(1 + 2**-23) and twice[-3] == np.float32(1 + 2**-22)


def _operands(g, n, f=38, c1=32, c2=64, seed=0):
    rng = np.random.default_rng(seed)
    adj = rng.random((g, n, n)) < 0.15
    adj = adj | adj.transpose(0, 2, 1)
    mask = np.ones((g, n), bool)
    for gi in range(g):
        mask[gi, n - int(rng.integers(0, n // 4)) :] = False
    adj &= mask[:, :, None] & mask[:, None, :]
    x_t = rng.normal(size=(f, g * n)).astype(np.float32)
    w1 = (rng.normal(size=(f, c1)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(c1, c2)) * 0.1).astype(np.float32)
    return adj.astype(np.int8), mask, x_t, w1, w2


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize(("g", "n", "c1", "c2"), [(4, 33, 32, 64), (3, 40, 6, 10)])
def test_tower_fwd_order_ref_is_the_tower_forward(compute_dtype, g, n, c1, c2) -> None:
    ops = _operands(g, n, c1=c1, c2=c2, seed=g * n)
    adj, mask, x_t, w1, w2 = (torch.from_numpy(v) for v in ops)
    h1, sign = td.tower_fwd_order_ref(adj, x_t, mask, w1, w2, compute_dtype)
    h1_r, sign_r, _ = td.tower_fwd_kernel_ref(adj, x_t, mask, w1, w2, compute_dtype)
    assert h1.dtype == torch.float32 and sign.dtype == torch.uint8
    h2 = td.diag_kernel_ref(adj, td.round_to(w2, td.activation_dtype(compute_dtype)).T @ td.round_to(h1_r, td.activation_dtype(compute_dtype)), mask, "relu_mask")
    clear = h2.abs() > 1e-4 * h2.abs().max()
    if compute_dtype is None:
        torch.testing.assert_close(h1, h1_r, rtol=1e-5, atol=1e-5)
        assert torch.equal(sign[clear], sign_r[clear])
        # the JAX package's forward: h1 and the sign of h2
        h1_j, h2_j, _ = (np.asarray(v) for v in jd._tower_ref(*ops))
        np.testing.assert_allclose(h1.numpy(), h1_j, **FWD_TOL)
        assert np.array_equal(sign.numpy()[clear.numpy()], (h2_j > 0).astype(np.uint8)[clear.numpy()])
    else:
        # the bf16 roundings are the plain version's; only the sums' order
        # differs, which can move a value onto the neighbouring bf16
        torch.testing.assert_close(h1, h1_r, rtol=2.0**-7, atol=1e-5)
        assert (sign[clear] != sign_r[clear]).float().mean() < 1e-2
