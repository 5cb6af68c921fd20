"""Host-side utilities of the featurization and the training runtime (port
of ``deeprank2_tpu/utils``)."""
