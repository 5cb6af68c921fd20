"""Host-side utilities of the training runtime (port of ``deeprank2_tpu/utils``)."""
