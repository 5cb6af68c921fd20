"""Tutorial: generate single-residue-variant (SRV) training data, with the
port (twin of ``tutorials/data_generation_srv.py``: the same arguments, demo
set and outputs).

Featurizes the local environment of single-residue variants at residue and
atomic resolution with ``deeprank2_tpu_torch.query.QueryCollection``.

Usage, from the repository root:
    python -m deeprank2_tpu_torch.tutorials.data_generation_srv [--data-path DIR] [--out DIR]
        [--limit N] [--no-grids]

``--data-path`` expects the reference tutorial layout: ``pdb/*.ent`` plus
``srv_target_values_curated.csv`` with columns ``pdb_file``, ``res_number``,
``res_wildtype``, ``res_variant``, ``target``. The tutorial set is Zenodo
record 8187806. Without ``--data-path`` the script runs in demo mode on the
vendored 101M structure with a few hand-picked variants.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os

from deeprank2_tpu_torch.dataset import GraphDataset
from deeprank2_tpu_torch.domain.aminoacidlist import amino_acids_by_code
from deeprank2_tpu_torch.features import components, contact
from deeprank2_tpu_torch.query import QueryCollection, SingleResidueVariantQuery
from deeprank2_tpu_torch.utils.grid import GridSettings, MapMethod

# the repository root, whose tests/data holds the demo structures
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# demo variants on the vendored 101M myoglobin structure (chain A):
# (residue number, wildtype 3-letter code, variant 3-letter code, target)
DEMO_VARIANTS = [
    (27, "ASP", "GLU", 0),
    (64, "HIS", "TYR", 1),
    (78, "LYS", "MET", 1),
    (98, "LYS", "ARG", 0),
]


def load_inputs(data_path: str | None, limit: int | None):
    """Rows of (pdb_file, res_number, wildtype, variant, target)."""
    if data_path is None:
        pdb = os.path.join(REPO, "tests", "data", "pdb", "101M", "101M.pdb")
        rows = [(pdb, num, wt, var, y) for num, wt, var, y in DEMO_VARIANTS]
    else:
        with open(os.path.join(data_path, "srv_target_values_curated.csv")) as fh:
            rows = [
                (
                    os.path.join(data_path, "pdb", r["pdb_file"]),
                    int(r["res_number"]),
                    r["res_wildtype"],
                    r["res_variant"],
                    int(r["target"]),
                )
                for r in csv.DictReader(fh)
            ]
    if limit:
        rows = rows[:limit]
    return rows


def featurize(rows, resolution, out_dir, with_grids, cpu_count):
    """One featurization pass (reference notebook cells 4-5 / 9-10)."""
    os.makedirs(out_dir, exist_ok=True)
    queries = QueryCollection()
    for pdb_file, res_number, wildtype, variant, target in rows:
        queries.add(
            SingleResidueVariantQuery(
                pdb_path=pdb_file,
                resolution=resolution,
                chain_ids="A",
                variant_residue_number=res_number,
                insertion_code=None,
                wildtype_amino_acid=amino_acids_by_code[wildtype],
                variant_amino_acid=amino_acids_by_code[variant],
                targets={"binary": target},
                influence_radius=10.0,  # local neighborhood around the SRV
                max_edge_length=4.5,
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
    processed = glob.glob(os.path.join(out_dir, "*.hdf5"))
    dataset = GraphDataset(processed, target="binary")
    df = dataset.hdf5_to_pandas()
    print(f"{len(df)} entries; columns: {list(df.columns)[:8]} ...")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-path", default=None, help="tutorial data dir; vendored demo variants when omitted")
    ap.add_argument("--out", default="data_processed/srv", help="output directory")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--no-grids", action="store_true")
    ap.add_argument("--cpu-count", type=int, default=2)
    ap.add_argument("--resolutions", nargs="+", default=["residue", "atom"], choices=["residue", "atom"])
    args = ap.parse_args(argv)

    rows = load_inputs(args.data_path, args.limit)
    print(f"Featurizing {len(rows)} SRVs ...")
    for resolution in args.resolutions:
        out_dir = os.path.join(args.out, resolution)
        featurize(rows, resolution, out_dir, not args.no_grids, args.cpu_count)
        explore(out_dir)


if __name__ == "__main__":
    main()
