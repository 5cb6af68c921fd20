"""Canonical HDF5 dataset names for edge features.

Schema-compatible with the reference (deeprank2/domain/edgestorage.py).

The port's copy of ``deeprank2_tpu/domain/edgestorage.py``: the HDF5 names are the
same byte for byte, so both packages read the same files.
"""

## main group
EDGE = "edge_features"

## metafeatures
NAME = "_name"
INDEX = "_index"

## generic features
DISTANCE = "distance"
SAMECHAIN = "same_chain"
SAMERES = "same_res"

## interactions
COVALENT = "covalent"
ELEC = "electrostatic"
VDW = "vanderwaals"
