"""Parameters between the JAX package and the port.

The JAX package keeps a model's parameters as a nested dict whose linear
layers are ``{"w": [in, out], "b": [out]}``; the port (and the reference)
keep a flat torch ``state_dict`` with ``{prefix}.weight [out, in]`` and
``{prefix}.bias [out]`` (the key layout of
``deeprank2_tpu/neuralnets/torch_interop.py``). The two functions below
convert one into the other and round-trip exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (JAX layout) -> torch ``state_dict`` (CPU tensors)."""
    state = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if key == "w":
            state[f"{prefix}weight"] = torch.from_numpy(np.array(np.asarray(value).T, order="C"))
        elif key == "b":
            state[f"{prefix}bias"] = torch.from_numpy(np.array(value))
        elif isinstance(value, dict):
            state.update(params_from_jax(value, f"{name}."))
        else:
            msg = f"unexpected parameter {name!r}: only linear layers ('w', 'b') are mapped"
            raise ValueError(msg)
    return state


def params_to_jax(state: dict[str, torch.Tensor]) -> dict:
    """torch ``state_dict`` -> nested dict of numpy arrays (JAX layout)."""
    tree: dict = {}
    for key, value in state.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        array = value.detach().cpu().numpy()
        if leaf == "weight":
            node["w"] = np.ascontiguousarray(array.T)
        elif leaf == "bias":
            node["b"] = array.copy()
        else:
            msg = f"unexpected state_dict key {key!r}: only '.weight' and '.bias' are mapped"
            raise ValueError(msg)
    return tree
