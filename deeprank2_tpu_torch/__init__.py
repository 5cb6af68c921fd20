"""deeprank2_tpu_torch — the PyTorch/CUDA port of ``deeprank2_tpu``.

Module paths mirror the JAX package (``ops/batch.py`` here is the port of
``deeprank2_tpu/ops/batch.py``, and so on). Plain tensor code is PyTorch;
every Pallas kernel of the JAX package becomes a hand-written CUDA kernel for
Hopper (``csrc/``), built with ``nvcc`` at its first launch, never at import.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :func:`deeprank2_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"
