"""HDF5 group name for grid-mapped features (reference: deeprank2/domain/gridstorage.py).

The port's copy of ``deeprank2_tpu/domain/gridstorage.py``: the HDF5 names are the
same byte for byte, so both packages read the same files.
"""

MAPPED_FEATURES = "mapped_features"
