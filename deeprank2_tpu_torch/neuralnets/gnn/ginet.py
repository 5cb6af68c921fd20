"""GINet conv parameters (port of ``deeprank2_tpu/neuralnets/gnn/ginet.py:init_ginet_conv``).

Only the parameter set is ported in this slice: the dense GINet uses ``fc``
alone, and the COO ``ginet_conv`` (with its edge attention) comes with the
COO models. ``fc_edge_attr`` and ``fc_attention`` stay in the set so that
state dicts keep the reference's keys and the optimizer sees every parameter.
"""

from __future__ import annotations

import torch
from torch import nn

from deeprank2_tpu_torch.neuralnets.nn import init_linear


def init_ginet_conv(
    in_channels: int,
    out_channels: int,
    number_edge_features: int = 1,
    generator: torch.Generator | None = None,
    device: torch.device | None = None,
) -> nn.ModuleDict:
    """One GINet conv layer's bias-free linear maps, PyG ``uniform(in_channels, ...)``
    init (reference ginet.py:33-38): ``fc``, ``fc_edge_attr``, ``fc_attention``."""
    size = in_channels
    fe = number_edge_features
    return nn.ModuleDict(
        {
            "fc": init_linear(in_channels, out_channels, False, size, generator, device),
            "fc_edge_attr": init_linear(fe, fe, False, size, generator, device),
            "fc_attention": init_linear(2 * out_channels + fe, 1, False, size, generator, device),
        }
    )
