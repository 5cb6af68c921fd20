"""Measurement scripts for the port, run on a CUDA device (``python -m
deeprank2_tpu_torch.tools.<name>``), and the float64 gate that they and
``chip_smoke.py`` hold the tower's routes to (``f64_gate``)."""
