"""The port's sorted segment sum (deeprank2_tpu_torch/ops/segment_sorted.py,
kernel K7's plain version and autograd Function) and the segment backend of
ops/segment.py against the JAX package on the CPU. JAX's Pallas kernel runs
in interpret mode, as tests/utils/test_pallas_segment.py runs it; sums agree
to summation order (atol 1e-4, that test's tolerance, against the kernel; 1e-6
elsewhere)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deeprank2_tpu.ops import pallas_segment as jps
from deeprank2_tpu.ops import segment as jseg
from deeprank2_tpu_torch.ops import segment as tseg
from deeprank2_tpu_torch.ops import segment_sorted as ss

KERNEL_TOL = {"rtol": 0, "atol": 1e-4}
SUM_TOL = {"rtol": 1e-6, "atol": 1e-6}


def _sorted_case(num_edges, num_segments, feat, seed, pad=64):
    """Ascending rows with ``pad`` padding entries at ``num_segments + 7``,
    messages and a cotangent."""
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, num_segments, size=num_edges)).astype(np.int32)
    if pad:
        rows[-pad:] = num_segments + 7
    msgs = rng.normal(size=(num_edges, feat)).astype(np.float32)
    cot = rng.normal(size=(num_segments, feat)).astype(np.float32)
    return msgs, rows, cot


def _oracle(msgs, rows, num_segments):
    out = np.zeros((num_segments, msgs.shape[1]), np.float64)
    keep = rows < num_segments
    np.add.at(out, rows[keep], msgs[keep])
    return out.astype(np.float32)


def _jax_kernel_vjp(msgs, rows, num_segments, cot):
    """JAX's segment_sum_sorted (the Pallas kernel, interpreted) and its VJP,
    in one jitted program: eager JAX ops dispatched while the interpreted
    kernel's host callbacks still run can deadlock."""

    @jax.jit
    def fwd_and_vjp(m, c):
        out, vjp = jax.vjp(lambda m: jps.segment_sum_sorted(m, jnp.asarray(rows), num_segments), m)
        return out, vjp(c)[0]

    with pltpu.force_tpu_interpret_mode():
        out, grad = fwd_and_vjp(jnp.asarray(msgs), jnp.asarray(cot))
        return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_ref_and_function_match_the_jax_kernel_and_its_vjp(seed) -> None:
    num_edges, num_segments, feat = 4096, 600, 32
    msgs, rows, cot = _sorted_case(num_edges, num_segments, feat, seed)
    want, want_grad = _jax_kernel_vjp(msgs, rows, num_segments, cot)
    np.testing.assert_allclose(want, _oracle(msgs, rows, num_segments), **KERNEL_TOL)

    ss.reset_launches()
    ref = ss.segment_sum_sorted_kernel_ref(torch.from_numpy(msgs), torch.from_numpy(rows), num_segments)
    np.testing.assert_allclose(ref.numpy(), want, **KERNEL_TOL)
    m = torch.from_numpy(msgs).requires_grad_(True)
    out = ss.segment_sum_sorted(m, torch.from_numpy(rows), num_segments)
    (grad,) = torch.autograd.grad(out, m, torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), want, **KERNEL_TOL)
    # the VJP is a gather: exact, and zero at the padding entries
    np.testing.assert_array_equal(grad.numpy(), want_grad)
    assert not grad[-64:].any()
    assert ss.launches == {"segment_sum_sorted_kernel": 0}  # the CPU takes the plain version


# F = 12, 16, 32 and one wider than a warp; empty segments; E = 0
@pytest.mark.parametrize(("num_edges", "num_segments", "feat"), [(700, 90, 12), (700, 90, 16), (3000, 400, 32), (500, 40, 70), (0, 9, 12)])
def test_kernel_ref_matches_the_oracle_and_gives_exact_zeros_on_empty_segments(num_edges, num_segments, feat) -> None:
    msgs, rows, _ = _sorted_case(num_edges, num_segments, feat, seed=num_edges + feat, pad=min(num_edges, 20))
    rows[(rows > 3) & (rows < 9)] = 2  # segments 4-8 empty (still ascending)
    rows = np.sort(rows)
    got = ss.segment_sum_sorted_kernel(torch.from_numpy(msgs), torch.from_numpy(rows), num_segments)
    assert got.shape == (num_segments, feat) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _oracle(msgs, rows, num_segments), **SUM_TOL)
    assert not got[4:9].any()


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take() -> None:
    msgs, rows, _ = _sorted_case(100, 10, 8, seed=3, pad=0)
    m, r = torch.from_numpy(msgs), torch.from_numpy(rows)
    with pytest.raises(TypeError, match="int32"):
        ss.segment_sum_sorted_kernel(m, r.long(), 10)
    with pytest.raises(TypeError, match="float32"):
        ss.segment_sum_sorted_kernel(m.double(), r, 10)
    with pytest.raises(ValueError, match="shape"):
        ss.segment_sum_sorted_kernel(m, r[:-1], 10)
    with pytest.raises(ValueError, match="contiguous"):
        ss.segment_sum_sorted_kernel(m.T.contiguous().T, r, 10)
    with pytest.raises(ValueError, match=r"\[E, F\]"):
        ss.segment_sum_sorted_kernel(m[:, 0], r, 10)
    with pytest.raises(ValueError, match="num_segments >= 1"):
        ss.segment_sum_sorted_kernel(m, r, 0)
    with pytest.raises(ValueError, match="no kernel"):
        ss.segment_sum_sorted_kernel(m.to("meta"), r.to("meta"), 10)


def test_sorting_wrapper_matches_jax() -> None:
    rng = np.random.default_rng(3)
    num_edges, num_segments, feat = 2048, 300, 16
    rows = rng.integers(0, num_segments + 2, size=num_edges).astype(np.int32)  # unsorted, some out of range
    msgs = rng.normal(size=(num_edges, feat)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():  # one jitted program, as in _jax_kernel_vjp
        want = np.asarray(jax.jit(jps.pallas_segment_sum, static_argnums=2)(jnp.asarray(msgs), jnp.asarray(rows), num_segments))
    got = ss.pallas_segment_sum(torch.from_numpy(msgs), torch.from_numpy(rows), num_segments)
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)
    np.testing.assert_allclose(got.numpy(), _oracle(msgs, rows, num_segments), **SUM_TOL)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_sorted_segment_sum_takes_the_plain_path_on_the_cpu(backend) -> None:
    msgs, rows, _ = _sorted_case(1000, 120, 16, seed=4)
    try:
        tseg.set_segment_backend(backend)
        ss.reset_launches()
        got = tseg.segment_sum(torch.from_numpy(msgs), torch.from_numpy(rows), 120, indices_sorted=True)
    finally:
        tseg.set_segment_backend("pallas")
    want = jseg.segment_sum(jnp.asarray(msgs), jnp.asarray(rows), 120, indices_sorted=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SUM_TOL)
    assert ss.launches == {"segment_sum_sorted_kernel": 0}


def test_set_segment_backend_validates() -> None:
    assert tseg._SEGMENT_BACKEND == "pallas"  # the default, as in the JAX package
    with pytest.raises(ValueError, match="unknown segment backend: cuda"):
        tseg.set_segment_backend("cuda")
    with pytest.raises(ValueError, match="unknown segment backend"):
        jseg.set_segment_backend("cuda")
    assert tseg._SEGMENT_BACKEND == "pallas"


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("shape", [(), (3,)])
def test_segment_softmax_matches_jax(with_valid, shape) -> None:
    rng = np.random.default_rng(len(shape) + 2 * with_valid)
    rows, num = 240, 30
    ids = rng.integers(0, num + 1, size=rows).astype(np.int32)  # id num is padding
    ids[ids == 4] = num  # segment 4 empty
    logits = (3 * rng.standard_normal((rows, *shape))).astype(np.float32)
    valid = rng.random(rows) > 0.2 if with_valid else None
    cot = rng.standard_normal((rows, *shape)).astype(np.float32)

    def jfn(x):
        return jseg.segment_softmax(x, jnp.asarray(ids), num, None if valid is None else jnp.asarray(valid))

    want, vjp = jax.vjp(jfn, jnp.asarray(logits))
    (want_grad,) = vjp(jnp.asarray(cot))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tseg.segment_softmax(x, torch.from_numpy(ids), num, None if valid is None else torch.from_numpy(valid))
    (grad,) = torch.autograd.grad(got, x, torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SUM_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-5)
    assert not got[torch.from_numpy(ids) == num].any()  # padding rows get probability 0
    sums = np.zeros((num, *shape), np.float64)
    np.add.at(sums, ids[ids < num], got.detach().numpy()[ids < num])
    live = np.bincount(ids[(ids < num) & (valid if valid is not None else True)], minlength=num + 1)[:num] > 0
    np.testing.assert_allclose(sums[live], 1.0, rtol=1e-5)


def test_gather_rows_reads_in_range_rows_and_spreads_the_padding() -> None:
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(10, 3)).astype(np.float32))
    index = torch.tensor([0, 9, 10, 10, 17, 3, 10], dtype=torch.int32)  # ids >= 10 are padding
    mask = (index < 10).float()[:, None]
    cot = torch.from_numpy(rng.normal(size=(7, 3)).astype(np.float32))
    grads = []
    for gather in (tseg.gather_rows, lambda t, i: t[i.clamp(max=9)]):  # the JAX package's clamp
        xt = x.clone().requires_grad_(True)
        out = gather(xt, index) * mask
        grads.append((out.detach(), torch.autograd.grad(out, xt, cot)[0]))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=0, atol=0)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=0, atol=0)
    # entry i of the padding reads row i mod 10: no row repeated by the padding
    torch.testing.assert_close(tseg.gather_rows(x, index)[[2, 3, 4, 6]], x[[2, 3, 4, 6]], rtol=0, atol=0)
