"""Measurement scripts for the port, run on a CUDA device (``python -m
deeprank2_tpu_torch.tools.<name>``)."""
