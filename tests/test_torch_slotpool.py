"""The port's slot max-pool (deeprank2_tpu_torch/ops/slotpool.py) against the
JAX package's (deeprank2_tpu/ops/pallas_slotpool.py) on the CPU.

On the CPU the port's kernel wrappers run their plain PyTorch versions; the
JAX side runs the TPU kernels in Pallas's interpret mode (``interpret=True``,
as tests/ops/test_slotpool.py does). A max and a comparison involve no sums,
so forward and VJP must agree exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprank2_tpu.ops.pallas_slotpool import TILE
from deeprank2_tpu.ops.pallas_slotpool import slot_group_max as jax_slot_group_max
from deeprank2_tpu_torch.ops import slotpool as sp

EXACT = {"rtol": 0, "atol": 0}


def _case(feat: int, vp: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Non-negative h with masked lanes zeroed, planted exact ties, an all-zero
    group and a group of masked lanes only; a cotangent for the pooled side."""
    rng = np.random.default_rng(seed)
    h = np.abs(rng.standard_normal((feat, vp)).astype(np.float32))
    mask = (rng.random(vp) > 0.1).astype(np.float32)
    h[:, 96:104] = 0.0
    mask[400:408] = 0.0
    h[3, 200] = h[3, 201] = h[3, 202] = 5.0  # a three-way tie at slot 8 and 4, a pair at slot 2
    h = h * mask[None, :]
    return h, mask.reshape(1, vp), rng.standard_normal((feat, vp)).astype(np.float32)


def _jax(h, mask_row, cot, slot):
    mask_j = jnp.asarray(mask_row)
    pooled, vjp = jax.vjp(lambda x: jax_slot_group_max(x, mask_j, interpret=True, slot=slot), jnp.asarray(h))
    (dh,) = vjp(jnp.asarray(cot[:, : h.shape[1] // slot]))
    return np.asarray(pooled), np.asarray(dh)


def _torch(fn, h, mask_row, cot, slot):
    x = torch.from_numpy(h).requires_grad_(True)
    pooled = fn(x, torch.from_numpy(mask_row), slot=slot)
    (dh,) = torch.autograd.grad(pooled, x, torch.from_numpy(np.ascontiguousarray(cot[:, : h.shape[1] // slot])))
    return pooled.detach().numpy(), dh.numpy()


@pytest.mark.parametrize("slot", [8, 4, 2])
@pytest.mark.parametrize("feat", [19, 32])
@pytest.mark.parametrize("vp", [2 * TILE, TILE + 8 * 13])
@pytest.mark.parametrize("fn", ["slot_group_max", "slot_group_max_ref"])
def test_fwd_vjp_match_jax_interpret_kernel_exactly(fn, vp, feat, slot) -> None:
    h, mask_row, cot = _case(feat, vp, seed=feat + slot)
    want_p, want_dh = _jax(h, mask_row, cot, slot)
    got_p, got_dh = _torch(getattr(sp, fn), h, mask_row, cot, slot)
    np.testing.assert_allclose(got_p, want_p, **EXACT)
    np.testing.assert_allclose(got_dh, want_dh, **EXACT)


@pytest.mark.parametrize("slot", [8, 4, 2])
def test_tie_rule_every_valid_winner_gets_the_full_cotangent(slot) -> None:
    """Group 0 is all zero with padded lanes after its valid ones; group 1 has
    two lanes tied at the max. Every valid max lane gets the full cotangent."""
    valid0 = max(1, slot // 2)
    h = np.zeros((1, 2 * slot), np.float32)
    mask = np.ones((1, 2 * slot), np.float32)
    mask[0, valid0:slot] = 0.0
    h[0, slot:] = 1.0
    h[0, slot : slot + 2] = 2.0
    x = torch.from_numpy(h).requires_grad_(True)
    sp.slot_group_max(x, torch.from_numpy(mask), slot=slot).sum().backward()
    want = np.zeros(2 * slot, np.float32)
    want[:valid0] = 1.0
    want[slot : slot + 2] = 1.0
    np.testing.assert_array_equal(x.grad.numpy()[0], want)


def test_plain_versions_of_both_kernels() -> None:
    h, mask_row, cot = _case(5, 512, seed=3)
    ht, mt = torch.from_numpy(h), torch.from_numpy(mask_row)
    for slot in sp.SLOTS:
        pooled = sp.slot_fwd_kernel(ht, slot)
        np.testing.assert_array_equal(pooled.numpy(), h.reshape(5, 512 // slot, slot).max(axis=2))
        g = torch.from_numpy(np.ascontiguousarray(cot[:, : 512 // slot]))
        dh = sp.slot_bwd_kernel(ht, mt, pooled, g, slot).numpy()
        eq = (h.reshape(5, 512 // slot, slot) == pooled.numpy()[:, :, None]) * mask_row.reshape(1, 512 // slot, slot)
        np.testing.assert_array_equal(dh, (eq * g.numpy()[:, :, None]).reshape(5, 512))


def test_wrappers_check_their_operands_and_count_no_cpu_launches() -> None:
    h, mask_row, _ = _case(4, 512, seed=1)
    ht, mt = torch.from_numpy(h), torch.from_numpy(mask_row)
    sp.reset_launches()
    x = ht.clone().requires_grad_(True)
    sp.slot_group_max(x, mt).sum().backward()
    assert sp.launches == {"slot_fwd_kernel": 0, "slot_bwd_kernel": 0}
    with pytest.raises(ValueError, match="multiple of slot"):
        sp.slot_fwd_kernel(ht[:, :508].contiguous(), 8)
    with pytest.raises(ValueError, match="multiple of slot"):
        sp.slot_group_max(ht[:, :510].contiguous(), mt[:, :510].contiguous(), slot=4)
    with pytest.raises(ValueError, match="slot must be"):
        sp.slot_fwd_kernel(ht, 16)
    with pytest.raises(ValueError, match="slot must be"):
        sp.slot_group_max(ht, mt, slot=3)
    with pytest.raises(TypeError):
        sp.slot_fwd_kernel(ht.double())
    with pytest.raises(TypeError):
        sp.slot_group_max(ht, mt.bool())
    with pytest.raises(ValueError, match="contiguous"):
        sp.slot_fwd_kernel(ht.T.contiguous().T)
    pooled = sp.slot_fwd_kernel(ht)
    with pytest.raises(ValueError, match="shape"):
        sp.slot_bwd_kernel(ht, mt, pooled[:, :-1].contiguous(), pooled)
    # neither CPU nor CUDA: no kernel and no plain version
    with pytest.raises(ValueError, match="no kernel"):
        sp.slot_fwd_kernel(ht.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        sp.slot_bwd_kernel(ht.to("meta"), mt.to("meta"), pooled.to("meta"), pooled.to("meta"))
