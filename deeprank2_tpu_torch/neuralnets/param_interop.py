"""Parameters between the JAX package and the port.

The JAX package keeps a model's parameters as a nested dict whose linear
layers are ``{"w": [in, out], "b": [out]}``; the port (and the reference)
keep a flat torch ``state_dict`` with ``{prefix}.weight [out, in]`` and
``{prefix}.bias [out]`` (the key layout of
``deeprank2_tpu/neuralnets/torch_interop.py``). The two functions below
convert one into the other and round-trip exactly.

The JAX tree's path is the ``state_dict`` prefix as it stands for GINet; a
model family whose reference names differ passes ``family``, which renames
the prefixes through :data:`FAMILY_PREFIXES`. FoutNet's and sGAT's conv
layers are raw ``[in, out]`` matrices, not linear layers (``conv1.wc``,
``conv1.wn``; sGAT ``conv1.weight [2*in, out]``): their families map those
keys untransposed (:data:`FAMILY_RAW`), with ``b`` as ``bias``, as
``deeprank2_tpu/neuralnets/torch_interop.py`` does. A Conv3d kernel
(``w [out, in, k, k, k]``, the CNNs') has one layout in both and copies
through untransposed. AlignmentGNN's tree holds lists (its MLPs and
layers), whose indices become ``state_dict`` path parts, and batch norms
``{"scale", "bias"}``, whose ``scale`` is the port's ``weight``.
"""

from __future__ import annotations

import numpy as np
import torch

# JAX tree path -> reference state_dict prefix, for the families whose names
# differ (VanillaNetwork: single-Linear nn.Sequential MLPs, torch_interop.py:_vanilla)
FAMILY_PREFIXES = {
    "vanilla": {
        **{f"external{i}.{mlp}": f"_external{i}._{mlp}.0" for i in (1, 2) for mlp in ("edge_mlp", "node_mlp")},
        "graph_mlp.fc1": "_graph_mlp.0",
        "graph_mlp.fc2": "_graph_mlp.2",
    },
    # the reference's CNN names (torch_interop.py:_cnn)
    "cnn": {"conv000": "convlayer_000", "conv002": "convlayer_002", "fc000": "fclayer_000", "fc001": "fclayer_001"},
}
# families whose names are the JAX tree's own (AlignmentGNN: lists and batch norms)
FAMILY_SAME = frozenset({"alignment"})
# raw (untransposed) conv matrices, by family: the same key in both layouts
# (reference foutnet.py:28-95 and sgat.py:38-113, torch_interop.py:57-76)
FAMILY_RAW = {
    "foutnet": frozenset(f"conv{i}.{m}" for i in (1, 2) for m in ("wc", "wn")),
    "sgat": frozenset(("conv1.weight", "conv2.weight")),
}


def _family(family: str | None) -> tuple[dict[str, str], frozenset]:
    """``(prefix renames, raw keys)`` of a model family."""
    if family is None:
        return {}, frozenset()
    if family not in FAMILY_PREFIXES and family not in FAMILY_RAW and family not in FAMILY_SAME:
        msg = f"unknown model family {family!r}; expected one of {sorted({*FAMILY_PREFIXES, *FAMILY_RAW, *FAMILY_SAME})} or None"
        raise ValueError(msg)
    return FAMILY_PREFIXES.get(family, {}), FAMILY_RAW.get(family, frozenset())


def _state(tree: dict, raw: frozenset, prefix: str = "") -> dict[str, torch.Tensor]:
    state = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if name in raw:
            state[name] = torch.from_numpy(np.array(value))
        elif key == "w":
            w = np.asarray(value)
            state[f"{prefix}weight"] = torch.from_numpy(np.array(w.T if w.ndim == 2 else w, order="C"))  # a conv kernel copies through
        elif key in ("b", "bias"):
            state[f"{prefix}bias"] = torch.from_numpy(np.array(value))
        elif key == "scale":  # a batch norm's
            state[f"{prefix}weight"] = torch.from_numpy(np.array(value))
        elif isinstance(value, dict):
            state.update(_state(value, raw, f"{name}."))
        elif isinstance(value, list):
            state.update(_state({str(i): v for i, v in enumerate(value)}, raw, f"{name}."))
        else:
            msg = f"unexpected parameter {name!r}: only linear and conv layers ('w', 'b'), batch norms ('scale', 'bias') and the family's raw matrices are mapped"
            raise ValueError(msg)
    return state


def _lists(node):
    """The JAX tree's lists back from dicts keyed 0, 1, ... (AlignmentGNN)."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node) and sorted(map(int, node)) == list(range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def params_from_jax(tree: dict, family: str | None = None) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (JAX layout) -> torch ``state_dict`` (CPU tensors)."""
    renames, raw = _family(family)
    state = {}
    for key, value in _state(tree, raw).items():
        prefix, leaf = key.rsplit(".", 1)
        state[f"{renames.get(prefix, prefix)}.{leaf}"] = value
    return state


def params_to_jax(state: dict[str, torch.Tensor], family: str | None = None) -> dict:
    """torch ``state_dict`` -> nested dict of numpy arrays (JAX layout)."""
    renames, raw = _family(family)
    renames = {v: k for k, v in renames.items()}
    tree: dict = {}
    for key, value in state.items():
        prefix, leaf = key.rsplit(".", 1)
        node = tree
        for part in renames.get(prefix, prefix).split("."):
            node = node.setdefault(part, {})
        array = value.detach().cpu().numpy()
        if key in raw:
            node[leaf] = array.copy()
        elif leaf == "weight" and array.ndim == 1:  # a batch norm's scale
            node["scale"] = array.copy()
        elif leaf == "weight":
            # a C-order copy: canonical strides even on a dimension of size 1
            # (np.ascontiguousarray keeps a transpose's), which a matmul's
            # rounding can follow
            node["w"] = (array.T if array.ndim == 2 else array).copy()
        elif leaf == "bias":  # a batch norm's (after its scale, as a state_dict orders them) keeps its name
            node["bias" if "scale" in node else "b"] = array.copy()
        else:
            msg = f"unexpected state_dict key {key!r}: only '.weight', '.bias' and the family's raw matrices are mapped"
            raise ValueError(msg)
    return _lists(tree)
