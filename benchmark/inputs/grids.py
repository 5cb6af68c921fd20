"""Mapped-feature grids ``[C, W, H, D]`` of standard normals and binary
targets, as ``ops/synthetic.py:grid_arrays`` draws them (the reference grid
protocol, ``tests/perf/cnn_perf.py``), drawn on the device from ``--seed``
and copied to the host once. The box and the features are the
configuration's."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

DATASET = "GridDataset"


@dataclass
class Grids:
    x: np.ndarray  # f32 [G, C, W, H, D]
    y: np.ndarray  # f32 [G]

    @property
    def count(self) -> int:
        return self.x.shape[0]


def make(count: int, traffic: dict, config: dict, seed: int, device: torch.device) -> Grids:  # noqa: ARG001 — the box is the configuration's
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(count, int(config["num_features"]), *config["box_shape"], generator=gen, device=device)
    y = (torch.rand(count, generator=gen, device=device) < 0.5).to(torch.float32)
    out = Grids(x.cpu().numpy(), y.cpu().numpy())
    del x
    return out


def entries(grids: Grids, names: list[str]):
    """Each grid's mapped features, one dataset a channel, by entry name."""
    channels = [f"mapped_{c:03d}" for c in range(grids.x.shape[1])]
    for g, name in enumerate(names):
        yield name, {**{f"mapped_features/{ch}": grids.x[g, c] for c, ch in enumerate(channels)}, "target_values/binary": grids.y[g]}
