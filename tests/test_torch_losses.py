"""The port's 19 loss classes (deeprank2_tpu_torch/ops/losses.py) against
their JAX twins (deeprank2_tpu/ops/losses.py) on seeded numpy inputs: one
case per loss and option (a mask over padded graphs, a per-class weight, the
loss's own arguments), values at rtol 1e-6 and atol 1e-7."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprank2_tpu.ops import losses as jax_losses
from deeprank2_tpu_torch.ops import losses as port_losses

TOL = {"rtol": 1e-6, "atol": 1e-7}
N, C, D = 6, 3, 5  # graphs, classes, embedding width
MASK = np.array([True, True, False, True, True, False])


def _log_softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(axis=-1, keepdims=True))).astype(np.float32)


def _inputs(name: str, rng: np.random.Generator) -> tuple:
    """The positional inputs of one loss, before the mask."""
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    sign = lambda: np.where(rng.random(N) < 0.5, -1.0, 1.0).astype(np.float32)  # noqa: E731
    labels = rng.integers(0, C, size=N).astype(np.int32)
    if name in ("MSELoss", "L1Loss", "SmoothL1Loss", "HuberLoss"):
        return f32(N), f32(N)
    if name == "CrossEntropyLoss":
        return f32(N, C), labels
    if name == "NLLLoss":
        return _log_softmax(f32(N, C)), labels
    if name == "BCELoss":
        return rng.uniform(0.02, 0.98, N).astype(np.float32), (rng.random(N) < 0.5).astype(np.float32)
    if name == "BCEWithLogitsLoss":
        return 3 * f32(N), (rng.random(N) < 0.5).astype(np.float32)
    if name in ("SoftMarginLoss", "HingeEmbeddingLoss"):
        return f32(N), sign()
    if name == "PoissonNLLLoss":
        return rng.uniform(0.1, 2.0, N).astype(np.float32), rng.poisson(1.5, N).astype(np.float32)
    if name == "GaussianNLLLoss":
        return f32(N), f32(N), rng.uniform(0.2, 2.0, N).astype(np.float32)
    if name == "KLDivLoss":
        return _log_softmax(f32(N, C)), np.exp(_log_softmax(f32(N, C)))
    if name == "MultiLabelMarginLoss":
        target = np.full((N, C), -1, dtype=np.int32)
        for i in range(N):
            pos = rng.permutation(C)[: 1 + i % 2]
            target[i, : len(pos)] = pos
        target[2, 2] = 0  # after the terminator: ignored
        return f32(N, C), target
    if name == "MultiLabelSoftMarginLoss":
        return f32(N, C), (rng.random((N, C)) < 0.5).astype(np.float32)
    if name == "CosineEmbeddingLoss":
        return f32(N, D), f32(N, D), sign()
    if name == "MarginRankingLoss":
        return f32(N), f32(N), sign()
    if name == "TripletMarginLoss":
        return f32(N, D), f32(N, D), f32(N, D)
    if name == "CTCLoss":
        t, length = 9, 3
        targets = rng.integers(1, C + 1, size=(N, length)).astype(np.int32)
        targets[0, 1] = targets[0, 0]  # a repeated label needs a blank between
        log_probs = _log_softmax(f32(t, N, C + 1))
        return log_probs, targets, np.array([9, 8, 9, 7, 9, 6], np.int32), np.array([3, 2, 3, 1, 3, 2], np.int32)
    raise KeyError(name)


# one case per loss and option: (loss, constructor kwargs, extra keyword inputs, masked)
CASES = {}
for _name in port_losses.__dict__:
    _cls = getattr(port_losses, _name)
    if isinstance(_cls, type) and issubclass(_cls, port_losses._Loss) and _cls is not port_losses._Loss:
        CASES[f"{_name}-plain"] = (_name, {}, False)
        CASES[f"{_name}-mask"] = (_name, {}, True)
for _name in ("CrossEntropyLoss", "NLLLoss", "BCELoss", "BCEWithLogitsLoss"):
    CASES[f"{_name}-weight"] = (_name, {"weight": np.array([0.2, 0.5, 0.3], np.float32)}, False)
    CASES[f"{_name}-weight-mask"] = (_name, {"weight": np.array([0.2, 0.5, 0.3], np.float32)}, True)
CASES.update(
    {
        "SmoothL1Loss-beta": ("SmoothL1Loss", {"beta": 0.5}, True),
        "HuberLoss-delta": ("HuberLoss", {"delta": 0.7}, True),
        "PoissonNLLLoss-probabilities": ("PoissonNLLLoss", {"log_input": False}, True),
        "GaussianNLLLoss-eps": ("GaussianNLLLoss", {"eps": 0.5}, True),
        "GaussianNLLLoss-no-var": ("GaussianNLLLoss", {}, "no_var"),
        "CosineEmbeddingLoss-margin": ("CosineEmbeddingLoss", {"margin": 0.2}, True),
        "MarginRankingLoss-margin": ("MarginRankingLoss", {"margin": 0.5}, True),
        "TripletMarginLoss-p1-swap": ("TripletMarginLoss", {"margin": 0.5, "p": 1.0, "swap": True}, True),
        "CTCLoss-blank-last": ("CTCLoss", {"blank": 3}, True),
    }
)


def test_every_loss_class_is_ported() -> None:
    names = {n for n, c in vars(jax_losses).items() if isinstance(c, type) and issubclass(c, jax_losses._Loss) and c is not jax_losses._Loss}
    assert len(names) == 19
    assert {case[0] for case in CASES.values()} == names


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_jax(case) -> None:
    name, kwargs, masked = CASES[case]
    rng = np.random.default_rng(sum(map(ord, name)))
    inputs = _inputs(name, rng)
    if name == "CTCLoss" and kwargs.get("blank") == 3:
        log_probs, targets, in_len, tgt_len = inputs
        inputs = (log_probs, targets - 1, in_len, tgt_len)  # labels 0..2, blank 3
    call_kw = {}
    if masked == "no_var":
        inputs = inputs[:2]
    elif masked:
        call_kw["mask"] = MASK
    want = getattr(jax_losses, name)(**kwargs)(*map(jnp.asarray, inputs), **{k: jnp.asarray(v) for k, v in call_kw.items()})
    port_kwargs = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kwargs.items()}
    got = getattr(port_losses, name)(**port_kwargs)(*map(torch.from_numpy, inputs), **{k: torch.from_numpy(v) for k, v in call_kw.items()})
    assert got.dtype == torch.float32 and got.shape == ()
    assert np.isfinite(float(got))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=case)


def test_ctc_impossible_alignment_stays_finite() -> None:
    """A target longer than its input has no alignment: every path is the
    finite stand-in for -inf, so the loss is huge but not NaN, as in JAX."""
    rng = np.random.default_rng(0)
    log_probs = _log_softmax(rng.normal(size=(2, 1, 4)).astype(np.float32))
    args = (log_probs, np.array([[1, 2, 3]], np.int32), np.array([2], np.int32), np.array([3], np.int32))
    want = np.asarray(jax_losses.CTCLoss()(*map(jnp.asarray, args)))
    got = port_losses.CTCLoss()(*map(torch.from_numpy, args))
    assert not np.isnan(float(got)) and float(got) > 1e29
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_loss_equality_hash_and_repr_follow_jax() -> None:
    for cls in (port_losses.CrossEntropyLoss, port_losses.MSELoss, port_losses.CTCLoss):
        twin = getattr(jax_losses, cls.__name__)
        assert cls() == cls() and hash(cls()) == hash(cls()) == hash(twin())
        assert repr(cls()) == repr(twin()) == f"{cls.__name__}()"
    assert port_losses.MSELoss() != port_losses.L1Loss()
    assert port_losses.CrossEntropyLoss(weight=torch.ones(2)) == port_losses.CrossEntropyLoss()
