"""Tutorial: generate PPI training data from raw PDB files, with the port
(twin of ``tutorials/data_generation_ppi.py``: the same arguments, demo set
and outputs).

Featurizes protein-protein interfaces at residue and atomic resolution into
HDF5 graphs + grids with ``deeprank2_tpu_torch.query.QueryCollection``.

Usage, from the repository root:
    python -m deeprank2_tpu_torch.tutorials.data_generation_ppi [--data-path DIR]
        [--out DIR] [--limit N] [--no-grids]

``--data-path`` expects the reference tutorial layout: ``pdb/*.pdb`` plus a
``BA_values.csv`` with columns ``ID`` (pdb stem) and ``measurement_value``
(binding affinity). The pMHC tutorial set is Zenodo record 8187806. Without
``--data-path`` the script runs in demo mode on the vendored 1ATN decoys
(chains A/B) with synthetic BA targets, so it works out of the box.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os

from deeprank2_tpu_torch.dataset import GraphDataset
from deeprank2_tpu_torch.features import components, contact
from deeprank2_tpu_torch.query import ProteinProteinInterfaceQuery, QueryCollection
from deeprank2_tpu_torch.utils.grid import GridSettings, MapMethod

# the repository root, whose tests/data holds the demo structures
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BINARY_TARGET_VALUE = 500  # BA threshold for the binary classification target


def load_inputs(data_path: str | None, limit: int | None):
    """(pdb_files, BA values, chain ids): tutorial layout or the demo set."""
    if data_path is None:
        pdb_files = sorted(glob.glob(os.path.join(REPO, "tests", "data", "pdb", "1ATN", "*.pdb")))
        if not pdb_files:
            msg = "no vendored demo PDBs found; pass --data-path"
            raise FileNotFoundError(msg)
        # synthetic BA values for the demo (deterministic, both classes present)
        bas = [100.0 + 900.0 * (i % 3) for i in range(len(pdb_files))]
        chains = ["A", "B"]
    else:
        with open(os.path.join(data_path, "BA_values.csv")) as fh:
            ba_by_id = {row["ID"]: float(row["measurement_value"]) for row in csv.DictReader(fh)}
        pdb_files = sorted(glob.glob(os.path.join(data_path, "pdb", "*.pdb")))
        pdb_files = [f for f in pdb_files if os.path.splitext(os.path.basename(f))[0] in ba_by_id]
        bas = [ba_by_id[os.path.splitext(os.path.basename(f))[0]] for f in pdb_files]
        chains = ["M", "P"]  # pMHC tutorial convention: MHC chain M, peptide P
    if limit:
        pdb_files, bas = pdb_files[:limit], bas[:limit]
    return pdb_files, bas, chains


def featurize(pdb_files, bas, chains, resolution, out_dir, with_grids, cpu_count):
    """One featurization pass (reference notebook cells 4-5 / 9-10)."""
    os.makedirs(out_dir, exist_ok=True)
    # residue graphs use an 8 Å interface cutoff, atomic graphs 5 Å — the
    # reference tutorial's settings
    radius = 8.0 if resolution == "residue" else 5.0

    queries = QueryCollection()
    for pdb_file, ba in zip(pdb_files, bas):
        queries.add(
            ProteinProteinInterfaceQuery(
                pdb_path=pdb_file,
                resolution=resolution,
                chain_ids=chains,
                influence_radius=radius,
                max_edge_length=radius,
                targets={
                    "binary": int(float(ba) <= BINARY_TARGET_VALUE),
                    "BA": ba,
                },
            ),
        )
    print(f"{len(queries)} {resolution} queries ready to be processed.")

    grid_settings = GridSettings(points_counts=[35, 30, 30], sizes=[1.0, 1.0, 1.0]) if with_grids else None
    grid_map_method = MapMethod.GAUSSIAN if with_grids else None
    queries.process(
        prefix=os.path.join(out_dir, "proc"),
        feature_modules=[components, contact],
        cpu_count=cpu_count,
        combine_output=False,
        grid_settings=grid_settings,
        grid_map_method=grid_map_method,
    )
    print(f"Processing done. HDF5 files are in {out_dir}.")


def explore(out_dir):
    """Inspect the generated dataset (reference notebook cells 6-8)."""
    processed = glob.glob(os.path.join(out_dir, "*.hdf5"))
    dataset = GraphDataset(processed, target="binary")
    df = dataset.hdf5_to_pandas()
    print(f"{len(df)} entries; columns: {list(df.columns)[:8]} ...")
    hist_path = os.path.join(out_dir, "res_mass_distance_electrostatic")
    try:
        dataset.save_hist(features=["res_mass", "distance", "electrostatic"], fname=hist_path)
        print(f"Feature histograms written to {hist_path}.png")
    except (KeyError, ValueError):
        pass  # demo feature subset may not include all three


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-path", default=None, help="tutorial data dir (pdb/ + BA_values.csv); demo set when omitted")
    ap.add_argument("--out", default="data_processed/ppi", help="output directory")
    ap.add_argument("--limit", type=int, default=None, help="use only the first N structures")
    ap.add_argument("--no-grids", action="store_true", help="graphs only, skip grid mapping")
    ap.add_argument("--cpu-count", type=int, default=2)
    ap.add_argument("--resolutions", nargs="+", default=["residue", "atom"], choices=["residue", "atom"])
    args = ap.parse_args(argv)

    pdb_files, bas, chains = load_inputs(args.data_path, args.limit)
    print(f"Featurizing {len(pdb_files)} PPI structures (chains {chains}) ...")
    for resolution in args.resolutions:
        out_dir = os.path.join(args.out, resolution)
        featurize(pdb_files, bas, chains, resolution, out_dir, not args.no_grids, args.cpu_count)
        explore(out_dir)


if __name__ == "__main__":
    main()
