"""Tutorial: train GNN and CNN classifiers on featurized HDF5 data, with the
port (twin of ``tutorials/training.py``).

Loads the HDF5 files that ``tutorials/data_generation_ppi.py`` (or
``_srv.py``) writes, makes a stratified train/valid/test split, trains a
VanillaNetwork GNN and a CnnClassification 3D-CNN with SGD through the
port's Trainer, and reports per-split metrics from the HDF5 exporter's
output (``output_exporter.hdf5`` and ``model.pth.tar`` under
``gnn_classif/`` and ``cnn_classif/`` of the data directory).

Usage, from the repository root:
    python -m deeprank2_tpu_torch.tutorials.training [--data data_processed/ppi/residue]
        [--epochs 20] [--models gnn cnn] [--device cuda|cpu]

It runs on the CUDA device unless ``--device cpu`` is given. It reads the
files with h5py and the exporter's output with pandas.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from deeprank2_tpu_torch.dataset import GraphDataset, GridDataset
from deeprank2_tpu_torch.neuralnets.cnn.model3d import CnnClassification
from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetwork
from deeprank2_tpu_torch.ops.optim import SGD
from deeprank2_tpu_torch.trainer import Trainer
from deeprank2_tpu_torch.utils.exporters import HDF5OutputExporter


def stratified_split(entries, targets, test_frac=0.1, valid_frac=0.2, seed=42):
    """Stratified train/valid/test split (the notebook's train_test_split)."""
    rng = np.random.default_rng(seed)
    entries, targets = np.asarray(entries), np.asarray(targets)
    test_idx, train_idx = [], []
    for cls in np.unique(targets):
        idx = rng.permutation(np.flatnonzero(targets == cls))
        n_test = max(int(round(test_frac * len(idx))), 1) if len(idx) > 1 else 0
        test_idx.extend(idx[:n_test])
        train_idx.extend(idx[n_test:])
    train_idx = np.asarray(train_idx)
    valid_idx, keep_idx = [], []
    for cls in np.unique(targets[train_idx]):
        idx = rng.permutation(train_idx[targets[train_idx] == cls])
        n_valid = max(int(round(valid_frac * len(idx))), 1) if len(idx) > 1 else 0
        valid_idx.extend(idx[:n_valid])
        keep_idx.extend(idx[n_valid:])
    if not valid_idx and len(keep_idx) > 1:  # tiny demo sets: never leave validation empty
        valid_idx.append(keep_idx.pop())
    return entries[np.asarray(keep_idx, int)], entries[np.asarray(valid_idx, int)], entries[np.asarray(test_idx, int)]


def read_targets(hdf5_files, target="binary"):
    import h5py

    names, values = [], []
    for fname in hdf5_files:
        with h5py.File(fname, "r") as f:
            for mol in f:
                names.append(mol)
                values.append(float(f[mol]["target_values"][target][()]))
    return names, values


def report_metrics(output_dir, epoch_saved):
    """AUC / accuracy / precision / recall / F1 per split (notebook cell 11)."""
    import pandas as pd

    exporter = HDF5OutputExporter(output_dir)
    out = exporter.read("training")
    try:
        out = pd.concat([out, exporter.read("testing")])
    except KeyError:
        pass
    threshold = 0.5
    for phase in ("training", "validation", "testing"):
        sel = out[(out.phase == phase) & (out.epoch == (epoch_saved if phase != "testing" else out[out.phase == phase].epoch.max()))]
        if not len(sel):
            continue
        y_true = np.asarray(sel.target, dtype=float)
        y_score = np.asarray(sel.output.tolist())[:, 1]
        y_pred = (y_score > threshold).astype(float)
        acc = float((y_pred == y_true).mean())
        tp = float(((y_pred == 1) & (y_true == 1)).sum())
        fp = float(((y_pred == 1) & (y_true == 0)).sum())
        fn = float(((y_pred == 0) & (y_true == 1)).sum())
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        # trapezoidal ROC-AUC without sklearn
        order = np.argsort(-y_score)
        yt = y_true[order]
        tps = np.cumsum(yt)
        fps = np.cumsum(1 - yt)
        if tps[-1] and fps[-1]:
            auc = float(np.trapezoid(np.r_[0, tps / tps[-1]], np.r_[0, fps / fps[-1]]))
        else:
            auc = float("nan")
        print(f"  {phase:10s}: AUC {auc:.2f}  acc {acc:.2f}  precision {precision:.2f}  recall {recall:.2f}  F1 {f1:.2f}")


def train_one(neuralnet, dataset_cls, input_files, splits, output_dir, args):
    train_entries, valid_entries, test_entries = splits
    kwargs = {}
    if dataset_cls is GraphDataset:
        kwargs = {
            "node_features": ["res_type"],
            "edge_features": ["distance"],
            "features_transform": {"all": {"transform": lambda x: np.cbrt(x), "standardize": True}},
        }
    print("Loading training data...")
    dataset_train = dataset_cls(hdf5_path=input_files, subset=list(train_entries), target="binary", task="classif", **kwargs)
    print("Loading validation data...")
    dataset_val = dataset_cls(hdf5_path=input_files, subset=list(valid_entries), train_source=dataset_train)
    print("Loading test data...")
    dataset_test = dataset_cls(hdf5_path=input_files, subset=list(test_entries), train_source=dataset_train)

    trainer = Trainer(
        neuralnet=neuralnet,
        dataset_train=dataset_train,
        dataset_val=dataset_val,
        dataset_test=dataset_test,
        output_exporters=[HDF5OutputExporter(output_dir)],
        device=args.device,
    )
    trainer.configure_optimizers(SGD, args.lr, weight_decay=args.weight_decay)
    trainer.train(
        nepoch=args.epochs,
        batch_size=args.batch_size,
        earlystop_patience=5,
        earlystop_maxgap=0.1,
        min_epoch=min(10, args.epochs),
        validate=True,
        filename=os.path.join(output_dir, "model.pth.tar"),
    )
    print(f"Model saved at epoch {trainer.epoch_saved_model}")
    trainer.test()
    report_metrics(output_dir, trainer.epoch_saved_model)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", default="data_processed/ppi/residue", help="directory of featurized .hdf5 files")
    ap.add_argument("--models", nargs="+", default=["gnn", "cnn"], choices=["gnn", "cnn"])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight-decay", type=float, default=0.001)
    ap.add_argument("--device", default="cuda", help="the device the Trainer runs on: cuda (default) or cpu")
    args = ap.parse_args(argv)

    input_files = sorted(glob.glob(os.path.join(args.data, "*.hdf5")))
    if not input_files:
        msg = f"no .hdf5 files in {args.data}; run tutorials/data_generation_ppi.py first"
        raise FileNotFoundError(msg)
    names, targets = read_targets(input_files)
    splits = stratified_split(names, targets)
    print(f"{len(names)} samples: {len(splits[0])} train / {len(splits[1])} valid / {len(splits[2])} test")

    if "gnn" in args.models:
        print("\n=== GNN (VanillaNetwork) ===")
        train_one(VanillaNetwork, GraphDataset, input_files, splits, os.path.join(args.data, "gnn_classif"), args)
    if "cnn" in args.models:
        print("\n=== CNN (CnnClassification) ===")
        train_one(CnnClassification, GridDataset, input_files, splits, os.path.join(args.data, "cnn_classif"), args)


if __name__ == "__main__":
    main()
