"""Measurement scripts for the port, run on a CUDA device (``python -m
deeprank2_tpu_torch.tools.<name>``), the float64 gate that they and
``chip_smoke.py`` hold the routes to (``f64_gate``), and the data tools
(``target``, ``similarity``, ``decoys``: labels and docking scores)."""
