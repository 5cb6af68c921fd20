"""The 3D CNN classifier as the reference publishes it (deeprank2's
``neuralnets/cnn/model3d.py``, ``CnnClassification``): Conv3d(C→4, k2),
relu, max-pool 2, Conv3d(4→5, k2), relu, max-pool 2, then FC(84), relu,
FC(2). Plain ``torch.nn.functional``."""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F


def _after_conv_pool(dim: int) -> int:
    return (dim - 1) // 2


def flat_size(box: tuple[int, int, int]) -> int:
    return 5 * math.prod(_after_conv_pool(_after_conv_pool(d)) for d in box)


def parameter_shapes(num_features: int, box: tuple[int, int, int], outputs: int = 2) -> dict[str, tuple[tuple[int, ...], int]]:
    """Each parameter's shape and fan-in, under the reference's state-dict keys."""
    flat = flat_size(box)
    return {
        "convlayer_000.weight": ((4, num_features, 2, 2, 2), num_features * 8),
        "convlayer_000.bias": ((4,), num_features * 8),
        "convlayer_002.weight": ((5, 4, 2, 2, 2), 4 * 8),
        "convlayer_002.bias": ((5,), 4 * 8),
        "fclayer_000.weight": ((84, flat), flat),
        "fclayer_000.bias": ((84,), flat),
        "fclayer_001.weight": ((outputs, 84), 84),
        "fclayer_001.bias": ((outputs,), 84),
    }


def forward(params: dict, batch: dict) -> torch.Tensor:
    """Logits ``[G, outputs]`` of grids ``batch["x"] [G, C, W, H, D]``."""
    x = F.max_pool3d(torch.relu(F.conv3d(batch["x"], params["convlayer_000.weight"], params["convlayer_000.bias"])), 2, 2)
    x = F.max_pool3d(torch.relu(F.conv3d(x, params["convlayer_002.weight"], params["convlayer_002.bias"])), 2, 2)
    x = torch.relu(x.reshape(x.shape[0], -1) @ params["fclayer_000.weight"].T + params["fclayer_000.bias"])
    return x @ params["fclayer_001.weight"].T + params["fclayer_001.bias"]
