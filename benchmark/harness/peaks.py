"""Published peaks of the H100 parts and the least time of a call.

A frozen copy of ``chip_smoke.py``'s ``PEAKS``, ``peaks()`` and ``bound()``:
NVIDIA's data sheets, dense rates without sparsity, at the full power limit
(700 W on SXM). Each entry is (memory bytes/s, f32 FLOP/s outside the tensor
cores, bf16 FLOP/s on the tensor cores)."""

from __future__ import annotations

PEAKS = {"PCIe": (2.0e12, 51e12, 756e12), "NVL": (3.9e12, 60e12, 835e12), "SXM": (3.35e12, 67e12, 989e12)}


def peaks(device_name: str) -> tuple[str, tuple[float, float, float]]:
    """The part of the H100 that ``device_name`` names (SXM unless the name
    says PCIe or NVL), and its ``PEAKS`` entry."""
    key = next((k for k in ("PCIe", "NVL") if k in device_name), "SXM")
    return key, PEAKS[key]


def bound_s(bytes_moved: float, flop: float, peak: tuple[float, float, float]) -> float:
    """The least seconds of a call: its bytes over the memory rate or its f32
    operations over the f32 rate, whichever takes longer (each input byte
    read once, each output byte written once)."""
    bw, f32, _ = peak
    return max(bytes_moved / bw, flop / f32)
