"""Device selection (the port's counterpart of ``ops/segment.py:effective_platform``).

The port runs on the CUDA card by default. Without CUDA it refuses to run
unless the caller asks for the CPU explicitly, so a missing card never turns
into a silent CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA when ``device`` is None.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by default)
    and no CUDA device is present; ``device="cpu"`` is the only way to run on
    the CPU (the tests do so)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        msg = "no CUDA device available; pass device='cpu' to run the plain PyTorch path on the CPU"
        raise RuntimeError(msg)
    if dev.type not in ("cuda", "cpu"):
        msg = f"unsupported device {dev}; the port runs on 'cuda' or 'cpu'"
        raise ValueError(msg)
    return dev
