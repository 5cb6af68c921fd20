"""HDF5 schema names and loss-type whitelists (port of ``deeprank2_tpu/domain``)."""
