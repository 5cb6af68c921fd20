"""The 3D CNN classifier on mapped-feature grids through the Trainer's grid
branch (``ops/batch.py:collate_grids``, cuDNN's convolutions through
``neuralnets/nn.py:conv3d`` in float32, PyTorch's max-pool)."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import cnn3d as reference

PORT_CLASS = "cnn.model3d.CnnClassification"
KERNEL_SOURCES: list[str] = []
forward = reference.forward


def parameter_shapes(config: dict) -> dict:
    """The reference's parameters at the configuration's features and box;
    the conv widths and the FC size are the published model's constants."""
    if (list(config["conv_channels"]), config["fc_size"]) != ([4, 5], 84):
        msg = "CnnClassification's convolutions are 4 and 5 wide and its FC layer 84"
        raise ValueError(msg)
    return reference.parameter_shapes(config["num_features"], tuple(config["box_shape"]), config["outputs"])


def batches(inputs, batch_size: int, device: torch.device, order=None):
    """The Trainer's chunks: ``batch_size`` grids after another of
    ``order``, by default the inputs' order."""

    def each():
        for start in range(0, inputs.count, batch_size):
            if order is None:
                chunk = slice(start, min(start + batch_size, inputs.count))
            else:
                chunk = np.asarray(order[start : start + batch_size])
            yield {"x": torch.from_numpy(inputs.x[chunk]).to(device)}, torch.from_numpy(inputs.y[chunk]).to(device)

    return each


def batch_info(inputs, batch_size: int) -> list[dict]:
    return [{"graphs": min(batch_size, inputs.count - start)} for start in range(0, inputs.count, batch_size)]


def _shapes(config: dict):
    c, box = config["num_features"], tuple(config["box_shape"])
    c1 = tuple(d - 1 for d in box)
    p1 = tuple(d // 2 for d in c1)
    c2 = tuple(d - 1 for d in p1)
    return c, box, c1, p1, c2


def conv_calls(config: dict, grids: int) -> dict:
    """Each convolution call of a batch with its bytes (inputs read once,
    outputs written once, f32) and operations: the two forwards, and the
    two backwards of a train step (``aten::convolution_backward``: conv1's
    weight and bias gradients, the grids needing none; conv2's data, weight
    and bias gradients)."""
    c, box, c1, p1, c2 = _shapes(config)
    vol = math.prod
    x, h1, h1p, h2 = (grids * ch * vol(s) * 4 for ch, s in ((c, box), (4, c1), (4, p1), (5, c2)))
    w1, w2 = (4 * c * 8 + 4) * 4, (5 * 4 * 8 + 5) * 4
    mac1, mac2 = grids * 4 * vol(c1) * c * 8, grids * 5 * vol(c2) * 4 * 8
    return {
        "forward": [{"bytes": x + w1 + h1, "flop": 2 * mac1}, {"bytes": h1p + w2 + h2, "flop": 2 * mac2}],
        "backward": [
            {"bytes": h1 + x + w1, "flop": 2 * mac1 + grids * 4 * vol(c1)},
            {"bytes": h2 + h1p + w2 + h1p + w2, "flop": 4 * mac2 + grids * 5 * vol(c2)},
        ],
    }


def flops(config: dict, info: dict, train: bool) -> float:
    """Model operations of one batch: the convolutions as :func:`conv_calls`
    counts them, the max-pools' comparisons and the FC layers' products
    (three times for a train step, the data gradient of each)."""
    _, _, c1, p1, c2 = _shapes(config)
    g = info["graphs"]
    calls = conv_calls(config, g)
    conv = sum(k["flop"] for k in calls["forward"]) + (sum(k["flop"] for k in calls["backward"]) if train else 0)
    flat = reference.flat_size(tuple(config["box_shape"]))
    fc = 2 * g * (flat * 84 + 84 * config["outputs"])
    pools = g * (4 * math.prod(p1) + 5 * flat // 5) * 7
    return float(conv + fc * (3 if train else 1) + pools)
