"""Checkpoint serialization (the port's counterpart of
``deeprank2_tpu/utils/checkpoint.py``).

The port writes the reference framework's own format: ``torch.save`` of the
Trainer's 28-key dict (reference trainer.py:910-958), with the model's
``state_dict`` under the reference's keys. The loss is written as its
``torch.nn`` twin of the same name, as the reference writes it, because the
JAX package rebuilds only torch, numpy and collections objects from such a
file; the optimizer is the port's class. So the JAX package's
``load_checkpoint`` reads a port checkpoint as a reference one.

:func:`load_checkpoint` reads three formats, all through a whitelisting
unpickler (torch, numpy, collections and the port's loss and optimizer
modules rebuild; anything else becomes an inert stub instead of running):

- the port's own files and the reference's zips: ``model_state_format`` is
  ``"torch"``; a ``torch.nn`` loss becomes the port's loss of that name, a
  ``torch.optim`` class the port's optimizer of that name, whose state is
  dropped (torch's state layout is not the port's);
- the JAX package's pickle checkpoints: ``deeprank2_tpu.ops.optim.*`` and
  ``deeprank2_tpu.ops.losses.*`` map to the port's classes by name, without
  importing the JAX package; ``model_state`` stays the JAX parameter tree
  (``model_state_format`` ``"jax"``, which the Trainer converts through
  ``neuralnets/param_interop.py``) and the optimizer state is dropped;
- orbax directories (``*.orbax``) are JAX's and raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import pickle
import zipfile

import torch

from deeprank2_tpu_torch.ops import losses as loss_nn
from deeprank2_tpu_torch.ops import optim

_log = logging.getLogger(__name__)

# constructor arguments a port loss shares with its torch.nn twin
_TWIN_ARGS = {
    "CrossEntropyLoss": ("weight",),
    "NLLLoss": ("weight",),
    "BCELoss": ("weight",),
    "BCEWithLogitsLoss": ("weight",),
    "SmoothL1Loss": ("beta",),
    "HuberLoss": ("delta",),
    "PoissonNLLLoss": ("log_input",),
    "GaussianNLLLoss": ("eps",),
    "CosineEmbeddingLoss": ("margin",),
    "MarginRankingLoss": ("margin",),
    "TripletMarginLoss": ("margin", "p", "eps", "swap"),
    "CTCLoss": ("blank",),
}
# modules whose classes load by name as the port's
_PORT_MODULES = {
    "deeprank2_tpu_torch.ops.losses": loss_nn,
    "deeprank2_tpu_torch.ops.optim": optim,
    "deeprank2_tpu.ops.losses": loss_nn,
    "deeprank2_tpu.ops.optim": optim,
}


def is_orbax_path(path: str) -> bool:
    return str(path).rstrip("/").endswith(".orbax")


def _refuse_orbax(path: str) -> None:
    if is_orbax_path(path):
        msg = f"{path}: orbax checkpoints belong to the JAX package; the port reads and writes torch.save files"
        raise NotImplementedError(msg)


def to_cpu(value):
    """A copy of ``value`` (tensors, dicts, lists, tuples) with every tensor a
    detached copy on the CPU."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    if isinstance(value, dict):
        return {k: to_cpu(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(to_cpu(v) for v in value)
    return value


def _reference_loss(loss):
    """The ``torch.nn`` twin of a port loss instance (anything else as it is)."""
    name = type(loss).__name__
    if not isinstance(loss, loss_nn._Loss) or not hasattr(torch.nn, name):
        return loss
    kwargs = {a: getattr(loss, a) for a in _TWIN_ARGS.get(name, ()) if getattr(loss, a, None) is not None}
    if "weight" in kwargs:
        kwargs["weight"] = torch.as_tensor(kwargs["weight"], dtype=torch.float32).cpu()
    return getattr(torch.nn, name)(**kwargs)


def _port_loss(obj):
    """A loss read from a checkpoint as the port's loss (None if unknown)."""
    if obj is None or isinstance(obj, loss_nn._Loss):
        return obj
    name = type(obj).__name__
    cls = getattr(loss_nn, name, None)
    if not isinstance(obj, torch.nn.Module) or cls is None:
        _log.warning(f"Unknown loss {name.removesuffix('_r')!r} in checkpoint; using task default.")
        return None
    return cls(**{a: getattr(obj, a) for a in _TWIN_ARGS.get(name, ()) if getattr(obj, a, None) is not None})


def save_checkpoint(state: dict, path: str) -> None:
    """``torch.save`` a Trainer checkpoint dict in the reference's format."""
    _refuse_orbax(path)
    torch.save({**to_cpu(state), "lossfunction": _reference_loss(state["lossfunction"])}, path)


def save_snapshot(state: dict, path: str) -> None:
    """``torch.save`` a resumable training snapshot (the port's own objects
    as they are; :func:`load_snapshot` reads it back)."""
    _refuse_orbax(path)
    torch.save(to_cpu(state), path)


def load_snapshot(path: str) -> dict:
    _refuse_orbax(path)
    return torch.load(path, map_location="cpu", weights_only=False, pickle_module=_PickleShim)


def load_checkpoint(path: str) -> dict:
    """Load a checkpoint written by the port, the reference (PyTorch)
    framework or the JAX package (pickle format) into the port's schema."""
    _refuse_orbax(path)
    if zipfile.is_zipfile(path):
        state = torch.load(path, map_location="cpu", weights_only=False, pickle_module=_PickleShim)
        state["model_state"] = dict(state["model_state"])
        state["model_state_format"] = "torch"
        opt = state.get("optimizer")
        if not (isinstance(opt, type) and issubclass(opt, optim.Optimizer)):
            state["optimizer_state"] = None  # torch's layout, not the port's
    else:
        with open(path, "rb") as f:
            state = _Unpickler(f).load()
        state["model_state_format"] = "jax"
        state["optimizer_state"] = None  # a JAX pytree, not the port's layout

    data_type = state.get("data_type")
    if not isinstance(data_type, str):
        state["data_type"] = getattr(data_type, "__name__", str(data_type))
    opt = state.get("optimizer")
    if not (isinstance(opt, type) and issubclass(opt, optim.Optimizer)):
        name = (opt.__name__ if isinstance(opt, type) else type(opt).__name__).removesuffix("_r")
        state["optimizer"] = getattr(optim, name, None)
        if not (isinstance(state["optimizer"], type) and issubclass(state["optimizer"], optim.Optimizer)):
            _log.warning(f"Unknown optimizer {name!r} in checkpoint; defaulting to Adam.")
            state["optimizer"] = optim.Adam
    state["lossfunction"] = _port_loss(state.get("lossfunction"))
    return state


# ---------------------------------------------------------------------------
# The whitelisting unpickler
# ---------------------------------------------------------------------------
class _InertMeta(type):
    """Metaclass for stub classes standing in for unimportable pickled types.

    Calling a stub returns another stub *class*; attribute access also
    yields stubs, and ``__setstate__`` absorbs any state. A file's
    ``deeprank2.*`` references and any other object outside the whitelist
    load inertly, without importing or running anything."""

    def __call__(cls, *args, **kwargs):  # noqa: ARG002
        return _inert(f"{cls.__name__}_r")

    def __getattr__(cls, name):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        return _inert(name)


def _inert(name: str) -> type:
    return _InertMeta(name, (), {"__setstate__": lambda *a, **k: None})


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _PORT_MODULES:
            found = getattr(_PORT_MODULES[module], name, None)
            if isinstance(found, type) and issubclass(found, (loss_nn._Loss, optim.Optimizer)):
                return found
            return _inert(name)
        root = module.split(".")[0]
        if root in ("torch", "numpy", "collections") or (module, name) == ("_codecs", "encode"):
            return super().find_class(module, name)
        return _inert(name)


class _PickleShim:
    Unpickler = _Unpickler
    load = staticmethod(pickle.load)
