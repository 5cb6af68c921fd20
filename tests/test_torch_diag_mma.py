"""The arithmetic that K1 and K2's tensor-core body (``diag_mma`` in
deeprank2_tpu_torch/csrc/diag_spmm.cu) relies on, checked on the CPU with the
port's plain versions (deeprank2_tpu_torch/ops/diag_spmm.py) and the JAX
package's oracle and near-f32 split (deeprank2_tpu/ops/diag_spmm.py).

- :func:`split3` cuts an f32 value into three bf16 pieces whose f32 sum is
  the value, bit for bit.
- K1's f32 form, computed piece by piece (``sum_p A @ piece_p`` in f32, as
  the kernel's three passes do), is its plain version and
  JAX's XLA oracle up to summation order (``TOL``), on int8 0/1 and
  bf16-weight adjacencies.
- K2's count form: on an int8 0/1 adjacency ``g_pool[f, g]`` added
  ``(A @ sign)[f, i]`` times in f32 is the sum over the row in ascending
  order bit for bit, and on bf16 weights ``g_pool[f, g] * (A @ sign)`` is
  the plain version at ``TOL``, in both forms (f32, and g_pool rounded to
  bf16).
- The control: JAX's two-piece hi/lo split misses ``TOL`` on the same
  inputs, which is why the kernel takes three pieces.
- The int8-to-bf16 tricks of the kernel's adjacency fragments are exact,
  and K2's count form holds on an int8 adjacency past 0/1 (negative counts).
- :func:`diag_body`, the one rule that names each form's body.

Inputs come from numpy seeds; everything runs on the CPU.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprank2_tpu.ops import diag_spmm as jd
from deeprank2_tpu_torch.ops import diag_spmm as td

TOL = {"rtol": 1e-5, "atol": 1e-5}
G, F = 16, 32
NODES = (32, 96, 296)  # the pooled adjacency, the ragged check, the clustered batch (not a multiple of 16)
ADJ = {"int8": torch.int8, "bfloat16": torch.bfloat16}


def _operands(adj_name: str, n: int, seed: int):
    """A symmetric adjacency of G graphs with a masked, edgeless tail (int8
    0/1, or bf16 weights |N(0, 1)| + 0.1 summed over both directions, as the
    weighted collates build them), x ~ N(0, 1) [F, G*N], a 0/1 sign and a
    pooled cotangent g_pool [F, G]."""
    rng = np.random.default_rng(seed)
    edges = rng.random((G, n, n)) < min(0.1, 16 / n)
    edges |= edges.transpose(0, 2, 1)
    mask = np.ones((G, n), bool)
    mask[:, n - n // 5 :] = False
    edges &= mask[:, :, None] & mask[:, None, :]
    if adj_name == "int8":
        adj = torch.from_numpy(edges.astype(np.int8))
    else:
        w = np.abs(rng.normal(size=(G, n, n))).astype(np.float32) + 0.1
        adj = torch.from_numpy(((w + w.transpose(0, 2, 1)) * edges).astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(F, G * n)).astype(np.float32))
    sign = torch.from_numpy((rng.random((F, G * n)) < 0.5).astype(np.uint8))
    g_pool = torch.from_numpy(rng.normal(size=(F, G)).astype(np.float32))
    return adj, x, sign, g_pool


def _by_pieces(adj: torch.Tensor, pieces) -> torch.Tensor:
    """K1's plain aggregate of each bf16 piece (exact products, f32 sums),
    the passes added in f32."""
    out = torch.zeros(F, adj.shape[0] * adj.shape[1])
    for p in pieces:
        out = out + td.diag_kernel_ref(adj, p.float())
    return out


# ---------------------------------------------------------------------------
# split3


def _magnitudes(lo_exp: int, hi_exp: int, sign: float, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    v = sign * 10.0 ** rng.uniform(lo_exp, hi_exp, size=20_000)
    return torch.from_numpy(v.astype(np.float32))


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize(("lo_exp", "hi_exp"), [(-30, -10), (-10, 10), (10, 30)])
def test_split3_sums_to_x_bit_for_bit(sign, lo_exp, hi_exp) -> None:
    x = _magnitudes(lo_exp, hi_exp, sign, seed=lo_exp + 100 + (1000 if sign < 0 else 0))
    hi, mid, lo = td.split3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.float() + mid.float() + lo.float()
    assert torch.equal(total.view(torch.int32), x.view(torch.int32))
    # each piece holds 8 significant bits below the last: |mid| < 2^-7 |x|, |lo| < 2^-15 |x|
    assert bool((mid.float().abs() < 2.0**-7 * x.abs()).all())
    assert bool((lo.float().abs() < 2.0**-15 * x.abs()).all())


def test_split3_of_zeros_is_zeros() -> None:
    """±0: every piece is a zero (hi keeps the sign), and the sum is zero."""
    x = torch.tensor([0.0, -0.0], dtype=torch.float32)
    hi, mid, lo = td.split3(x)
    assert torch.equal(torch.signbit(hi), torch.tensor([False, True]))
    assert not bool(mid.any()) and not bool(lo.any())
    assert bool(((hi.float() + mid.float() + lo.float()) == x).all())


# ---------------------------------------------------------------------------
# K1 and K2 as the tensor-core body computes them


@pytest.mark.parametrize("n", NODES)
@pytest.mark.parametrize("adj_name", sorted(ADJ))
def test_k1_by_pieces_matches_plain_and_jax(adj_name, n) -> None:
    adj, x, _, _ = _operands(adj_name, n, seed=n)
    got = _by_pieces(adj, td.split3(x))
    torch.testing.assert_close(got, td.diag_kernel_ref(adj, x), **TOL)
    ref = np.asarray(jd.diag_spmm_t_xla(jnp.asarray(adj.float().numpy()), jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("n", NODES)
@pytest.mark.parametrize("adj_name", sorted(ADJ))
def test_k1_bf16_form_is_one_piece(adj_name, n) -> None:
    """The bf16 form's operand is bf16 already: one pass, its only piece."""
    adj, x, _, _ = _operands(adj_name, n, seed=n + 1)
    xb = x.to(torch.bfloat16)
    hi, mid, lo = td.split3(xb.float())
    assert torch.equal(hi, xb) and not bool(mid.any()) and not bool(lo.any())
    torch.testing.assert_close(_by_pieces(adj, (hi,)), td.diag_kernel_ref(adj, x, compute_dtype=torch.bfloat16), **TOL)


def _ascending_sum(adj: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``sum_j A[i, j] u[f, j]`` in f32 in ascending j, one rounding a term:
    the order of K2's plain version on the card, the FMA body and the fused
    tower's backward."""
    g, n, _ = adj.shape
    u3, a = u.reshape(-1, g, n), adj.float()
    acc = torch.zeros_like(u3)
    for j in range(n):
        acc = acc + a[None, :, :, j] * u3[:, :, j : j + 1]
    return acc.reshape(u.shape)


@pytest.mark.parametrize("n", NODES)
@pytest.mark.parametrize("form", [None, torch.bfloat16])
@pytest.mark.parametrize("adj_name", sorted(ADJ))
def test_k2_count_form_matches_plain(adj_name, form, n) -> None:
    """The count ``(A @ sign)[f, i]`` is an exact integer on an int8
    adjacency (the kernel's s8 pass); ``g_pool[f, g]`` (rounded to bf16 in
    the bf16 form) added that many times in f32, all outputs in step, is the
    ascending-order sum over the row bit for bit. On bf16 weights the count
    is a sum of exact products in f32, scaled by ``g_pool`` once."""
    adj, _, sign, g_pool = _operands(adj_name, n, seed=n + 2)
    count = td.diag_kernel_ref(adj, sign.float())
    gp = td.round_to(g_pool, td.activation_dtype(form)).repeat_interleave(n, dim=1)
    if adj.dtype == torch.int8:
        assert torch.equal(count, count.round())
        got = torch.zeros_like(gp)
        for k in range(int(count.max().item())):
            got = got + torch.where(k < count, gp, torch.zeros_like(gp))
        assert torch.equal(got, _ascending_sum(adj, gp * sign.float()))
    else:
        got = gp * count
    torch.testing.assert_close(got, td.pool_bwd_kernel_ref(adj, sign, g_pool, form), **TOL)


@pytest.mark.parametrize("n", (32, 96))
@pytest.mark.parametrize("form", [None, torch.bfloat16])
def test_k2_count_form_on_a_signed_int8_adjacency(form, n) -> None:
    """Int8 entries in {-2, -1, 0, 1, 3}: the count is still an exact integer,
    now of either sign; the kernel adds ``g_pool`` that many times where it
    is not negative and multiplies once where it is, which is the plain
    version at ``TOL``."""
    adj, _, sign, g_pool = _operands("int8", n, seed=n + 5)
    rng = np.random.default_rng(n)
    weights = torch.from_numpy(rng.choice(np.array([-2, -1, 1, 3], np.int8), size=tuple(adj.shape)))
    adj = torch.where(adj != 0, weights, adj)
    count = td.diag_kernel_ref(adj, sign.float())
    assert torch.equal(count, count.round()) and (count < 0).any() and (count > 0).any()
    gp = td.round_to(g_pool, td.activation_dtype(form)).repeat_interleave(n, dim=1)
    seq = torch.zeros_like(gp)
    for k in range(int(count.max().item())):
        seq = seq + torch.where(k < count, gp, torch.zeros_like(gp))
    got = torch.where(count >= 0, seq, gp * count)
    torch.testing.assert_close(got, td.pool_bwd_kernel_ref(adj, sign, g_pool, form), **TOL)


# ---------------------------------------------------------------------------
# which body runs each form


@pytest.mark.parametrize("kernel", ["diag_kernel", "pool_bwd_kernel"])
@pytest.mark.parametrize(("adj_dtype", "act_dtype"), td.FORMS)
def test_diag_body_by_form(kernel, adj_dtype, act_dtype) -> None:
    """The f32 adjacency runs the FMA body, every other form the tensor
    cores, K1's f32 form on int8 included; the body's code is the kernel's."""
    fma = adj_dtype == torch.float32
    body = td.diag_body(kernel, adj_dtype, act_dtype)
    assert body == ("fma" if fma else "mma")
    assert td.BODIES[body] == (1 if fma else 0)


def test_diag_body_refuses_what_is_no_form() -> None:
    with pytest.raises(ValueError, match="kernel must be"):
        td.diag_body("tower_fwd_kernel", torch.int8, torch.float32)
    with pytest.raises(TypeError, match="must be one of"):
        td.diag_body("diag_kernel", torch.float32, torch.bfloat16)


@pytest.mark.parametrize("n", NODES)
@pytest.mark.parametrize("adj_name", sorted(ADJ))
def test_two_pieces_miss_the_f32_gate(adj_name, n) -> None:
    """The control: JAX's near-f32 hi/lo split (``_hi_lo_split``) leaves up
    to 2^-18 of each term out. On these inputs its two passes miss ``TOL``
    against the plain version: measured on the CPU, the largest error was
    3.4e-5, 4.9e-5 and 6.9e-5 on the int8 adjacency and 7.6e-5, 1.3e-4 and
    1.4e-4 on the bf16 weights (N = 32, 96, 296), where three pieces were
    within 9.5e-7 to 1.5e-5 of it, inside ``TOL``."""
    adj, x, _, _ = _operands(adj_name, n, seed=n)
    hi, lo = (torch.from_numpy(np.array(p.astype(jnp.float32))).to(torch.bfloat16) for p in jd._hi_lo_split(jnp.asarray(x.numpy())))
    want = td.diag_kernel_ref(adj, x)
    two = _by_pieces(adj, (hi, lo))
    excess = (two - want).abs() - (TOL["atol"] + TOL["rtol"] * want.abs())
    assert excess.max().item() > 0, f"two pieces stayed inside TOL (largest error {(two - want).abs().max().item():.3g})"
    with pytest.raises(AssertionError):
        torch.testing.assert_close(two, want, **TOL)


# ---------------------------------------------------------------------------
# the int8 entries as bf16, without a conversion instruction


def test_int8_exponent_trick_is_exact() -> None:
    """Any int8 b: the f32 bits 0x4B0000uu (u = b + 128, the byte XOR 0x80)
    are 2^23 + u; less 2^23 + 128 that is b, and the bf16 of b is the top
    half of its bits."""
    b = np.arange(-128, 128, dtype=np.int32)
    u = (b & 0xFF) ^ 0x80
    v = (np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(v, b.astype(np.float32))
    top = (v.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    assert np.array_equal(top, v)
    assert torch.equal(torch.from_numpy(top).to(torch.bfloat16).float(), torch.from_numpy(v))


def test_binary_entries_as_bf16_bits() -> None:
    """A 0/1 entry times 0x3F80 is the bf16 bits of 0.0 or 1.0; two such
    bytes placed in the halves of a word stay apart."""
    for b0 in (0, 1):
        for b1 in (0, 1):
            word = np.uint32((b0 | b1 << 16) * 0x3F80)
            halves = np.array([word & 0xFFFF, word >> 16], dtype=np.uint32) << 16
            assert np.array_equal(halves.view(np.float32), np.array([b0, b1], np.float32))
