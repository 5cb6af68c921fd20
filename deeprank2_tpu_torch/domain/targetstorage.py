"""Target names, task names, and the HDF5 group they live in.

On-disk schema vocabulary matching the reference layout
(deeprank2/domain/targetstorage.py) so datasets interoperate. The
``TARGET_TASKS`` mapping drives automatic task inference in the dataset layer.

The port's copy of ``deeprank2_tpu/domain/targetstorage.py``: the HDF5 names are the
same byte for byte, so both packages read the same files.
"""

# HDF5 group holding per-entry target values
VALUES = "target_values"

# task identifiers
REGRESS = "regress"
CLASSIF = "classif"

# built-in docking-quality targets and their tasks
BINARY = "binary"  # classification: irmsd < 4 Å
CAPRI = "capri_class"  # classification: CAPRI quality class 1..4
IRMSD = "irmsd"  # regression: interface RMSD (Å)
LRMSD = "lrmsd"  # regression: ligand RMSD (Å)
FNAT = "fnat"  # regression: fraction of native contacts
DOCKQ = "dockq"  # regression: DockQ score

TARGET_TASKS = {
    IRMSD: REGRESS,
    LRMSD: REGRESS,
    FNAT: REGRESS,
    DOCKQ: REGRESS,
    BINARY: CLASSIF,
    CAPRI: CLASSIF,
}
