"""Target tools: add labels to HDF5 datasets and compute docking-quality scores
(reference: deeprank2/tools/target.py).

The port's copy of ``deeprank2_tpu/tools/target.py``; ``h5py`` loads inside
``add_target``, the one function that opens a file.
"""

from __future__ import annotations

import glob
import logging
import os

from deeprank2_tpu_torch.domain import targetstorage as targets
from deeprank2_tpu_torch.tools.similarity import StructureSimilarity

_log = logging.getLogger(__name__)
MIN_IRMS_FOR_BINARY = 4
# CAPRI class by irmsd: < 1 Å -> 1 (high), < 2 -> 2, < 4 -> 3, else 4
_CAPRI_THRESHOLDS = ((1.0, 1), (2.0, 2), (4.0, 3))


def _load_label_file(target_list: str, sep: str) -> dict[str, float]:
    """``<entry-id><sep><value>`` lines -> {entry: value} (reference format,
    target.py:15-43)."""
    table: dict[str, float] = {}
    with open(target_list) as fh:
        for raw in fh:
            raw = raw.strip()
            if not raw or raw.startswith("#"):  # comment lines, like np.loadtxt
                continue
            cells = [c for c in raw.split(sep) if c]  # repeated separators collapse
            entry, value = cells[:2]
            table[entry] = float(value)
    return table


def _resolve_hdf5_paths(graph_path: str | list[str]) -> list[str]:
    if isinstance(graph_path, list):
        return graph_path
    if isinstance(graph_path, str):
        if os.path.isdir(graph_path):
            return glob.glob(f"{graph_path}/*.hdf5")
        if os.path.isfile(graph_path):
            return [graph_path]
    msg = f"graph_path must be an hdf5 file, a directory of them, or a list of paths; got {graph_path!r}"
    raise TypeError(msg)


def add_target(
    graph_path: str | list[str],
    target_name: str,
    target_list: str,
    sep: str = " ",
) -> None:
    """Write one label per matching entry of the given hdf5 file(s), under
    ``<entry>/target_values/<target_name>`` (replacing any existing value)."""
    table = _load_label_file(target_list, sep)

    for hdf5 in _resolve_hdf5_paths(graph_path):
        _log.info(hdf5)
        if not os.path.isfile(hdf5):
            msg = f"no such hdf5 file: {hdf5}"
            raise FileNotFoundError(msg)
        try:
            import h5py

            with h5py.File(hdf5, "a") as f5:
                for entry, value in table.items():
                    if entry not in f5:
                        _log.info(f"entry {entry} absent from {hdf5}; skipped")
                        continue
                    values_grp = f5[entry].require_group(targets.VALUES)
                    values_grp.pop(target_name, None)
                    values_grp.create_dataset(target_name, data=value)
        except OSError:  # noqa: PERF203
            _log.info(f"unreadable hdf5 skipped: {hdf5}")


def compute_ppi_scores(pdb_path: str, reference_pdb_path: str) -> dict[str, float | int]:
    """Structure-similarity scores of a docking model vs the native structure.

    Returns ``lrmsd``, ``irmsd``, ``fnat``, ``dockq``, ``binary``
    (irmsd < 4 Å) and ``capri_class`` (1 high ... 4 incorrect), matching the
    reference semantics (target.py:80-123). Instead of the reference's
    on-disk ``<ref>.lzone``/``.izone`` files, the native's parse, interface
    zone, and contact set are cached in memory per reference path
    (tools/similarity.py: reference_bundle) — scoring many decoys of one
    complex zones it once.
    """
    sim = StructureSimilarity(pdb_path, reference_pdb_path)
    lrmsd = sim.compute_lrmsd_fast(method="svd")
    irmsd = sim.compute_irmsd_fast(method="svd")
    fnat = sim.compute_fnat_fast()

    capri = 4
    for threshold, cls in _CAPRI_THRESHOLDS:
        if irmsd < threshold:
            capri = cls
            break

    return {
        targets.LRMSD: lrmsd,
        targets.IRMSD: irmsd,
        targets.FNAT: fnat,
        targets.DOCKQ: sim.compute_DockQScore(fnat, lrmsd, irmsd),
        targets.BINARY: irmsd < MIN_IRMS_FOR_BINARY,
        targets.CAPRI: capri,
    }
