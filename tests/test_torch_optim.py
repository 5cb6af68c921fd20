"""The port's optimizers (deeprank2_tpu_torch/ops/optim.py) against the JAX
package's over 20 steps on one seeded parameter set, one parameter of which
never gets a gradient (a zero gradient in JAX: it still decays), at atol
1e-6 (Adam's bias correction is f32 in JAX and double in the port: one f32
step apart); and the port's loss whitelists (domain/losstypes.py) against
JAX's, class name for class name."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprank2_tpu.domain import losstypes as jax_losstypes
from deeprank2_tpu.ops import optim as jax_optim
from deeprank2_tpu_torch.domain import losstypes as port_losstypes
from deeprank2_tpu_torch.ops import optim as port_optim

STEPS = 20
ATOL = 1e-6
SHAPES = {"w": (4, 3), "b": (3,), "idle": (2, 2)}  # "idle" never gets a gradient

CASES = {
    "Adam": ("Adam", {"lr": 1e-2, "weight_decay": 0.0}),
    "Adam-wd": ("Adam", {"lr": 1e-2, "weight_decay": 1e-2}),
    "AdamW": ("AdamW", {"lr": 1e-2, "weight_decay": 0.0}),
    "AdamW-wd": ("AdamW", {"lr": 1e-2, "weight_decay": 1e-2}),
    "SGD": ("SGD", {"lr": 5e-2, "momentum": 0.0, "weight_decay": 0.0}),
    "SGD-wd": ("SGD", {"lr": 5e-2, "momentum": 0.0, "weight_decay": 1e-2}),
    "SGD-momentum": ("SGD", {"lr": 5e-2, "momentum": 0.9, "weight_decay": 0.0}),
    "SGD-momentum-wd": ("SGD", {"lr": 5e-2, "momentum": 0.9, "weight_decay": 1e-2}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_jax_over_20_steps(case) -> None:
    name, kwargs = CASES[case]
    rng = np.random.default_rng(3)
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items() if k != "idle"} for _ in range(STEPS)]

    jopt = getattr(jax_optim, name)(**kwargs)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = jopt.init(params)
    for g in grads:
        params, state = jopt.step(params, {**{k: jnp.asarray(v) for k, v in g.items()}, "idle": jnp.zeros(SHAPES["idle"])}, state)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = getattr(port_optim, name)(list(tparams.values()), **kwargs)
    for g in grads:
        opt.zero_grad(set_to_none=True)
        for k, v in g.items():
            tparams[k].grad = torch.from_numpy(v)
        opt.step()
    assert tparams["idle"].grad is None
    for k in SHAPES:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(params[k]), rtol=0, atol=ATOL, err_msg=f"{case} {k}")
    if kwargs["weight_decay"]:
        assert not np.array_equal(tparams["idle"].detach().numpy(), init["idle"])  # decayed without a gradient


@pytest.mark.parametrize("name", ["Adam", "AdamW", "SGD"])
def test_optimizer_base_fields_state_dict_and_repr(name) -> None:
    cls = getattr(port_optim, name)
    p = torch.nn.Parameter(torch.ones(3))
    opt = cls([p], lr=0.05, weight_decay=1e-3)
    assert isinstance(opt, port_optim.Optimizer) and isinstance(opt, torch.optim.Optimizer)
    assert (opt.lr, opt.weight_decay) == (0.05, 1e-3)
    assert repr(opt) == repr(getattr(jax_optim, name)(lr=0.05, weight_decay=1e-3))
    p.grad = torch.full((3,), 0.5)
    opt.step()
    state = opt.state_dict()
    assert {k: state[k] for k in ("type", "lr", "weight_decay")} == getattr(jax_optim, name)(lr=0.05, weight_decay=1e-3).state_dict()
    q = torch.nn.Parameter(p.detach().clone())
    other = cls([q], lr=0.05, weight_decay=1e-3)
    other.load_state_dict(state)
    for opt_, param in ((opt, p), (other, q)):
        param.grad = torch.full((3,), -0.25)
        opt_.step()
    assert torch.equal(p, q)


@pytest.mark.parametrize(
    "whitelist",
    [
        "regression_losses",
        "binary_classification_losses",
        "multi_classification_losses",
        "other_losses",
        "classification_losses",
        "classification_tested",
    ],
)
def test_losstypes_whitelists_match_jax(whitelist) -> None:
    port = [cls.__name__ for cls in getattr(port_losstypes, whitelist)]
    assert port == [cls.__name__ for cls in getattr(jax_losstypes, whitelist)]
    assert all(cls.__module__ == "deeprank2_tpu_torch.ops.losses" for cls in getattr(port_losstypes, whitelist))


def test_jax_tree_is_the_step_input() -> None:
    """The JAX optimizers take every parameter's gradient, so the port's
    "no .grad" is a zero gradient there (the convention the cases above use)."""
    opt = jax_optim.SGD(lr=1.0, weight_decay=0.5)
    params = {"p": jnp.ones(2)}
    new, _ = opt.step(params, jax.tree.map(jnp.zeros_like, params), opt.init(params))
    np.testing.assert_allclose(np.asarray(new["p"]), 0.5)
