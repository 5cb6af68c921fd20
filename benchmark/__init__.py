"""The benchmark of ``deeprank2_tpu_torch``: ``python3 benchmark/run.py``."""
