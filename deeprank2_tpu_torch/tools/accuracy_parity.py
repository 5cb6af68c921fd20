"""Accuracy-parity harness: the port against a torch mirror of the reference
(port of ``deeprank2_tpu/tools/accuracy_parity.py``).

One command runs featurize -> train -> evaluate for the twelve
configurations and reports metric trajectories (per-epoch loss, plus
AUC/MCC/accuracy for classification and MSE/Pearson for regression) for
BOTH sides on the SAME featurized corpus and batch schedule:

    python -m deeprank2_tpu_torch.tools.accuracy_parity --data tests/data --out parity_out

The port's side runs through its product path (QueryCollection ->
GraphDataset/GridDataset -> Trainer with the default loss, shuffle off,
dropout off where a model has it, ``ops/optim.py:ReferenceAdam``), on CUDA
unless ``--device cpu``.
The mirror re-implements the reference pipeline
(deeprank2/neuralnets/gnn/*.py, cnn/model3d.py, trainer.py loss
accounting) in plain float32 torch on the CPU, on the entries the port's
dataset gives and the same batch chunks, from the port's initial
parameters: the card is held to the reference math, never to itself.

The corpus is assembled from a reference-layout data directory (PDBs +
PSSMs): 1ATN/3C8P complexes and generated rigid-body decoys scored against
their bound references with ``compute_ppi_scores``, the other vendored
complexes with deterministic labels, and single-residue variants with a
physics-derived severity target. ``store="hdf5"`` (the default) featurizes
with ``QueryCollection.process`` into HDF5 files, as the JAX harness does;
``store="memory"`` builds every query in this process into a
``utils/store.py:MemoryStore`` that the datasets, the feature statistics
and the Trainer's cluster writes read through the same code, for machines
without h5py. The store is always named by the caller: a missing h5py
under ``store="hdf5"`` raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np

# ---------------------------------------------------------------------------
# Metrics (numpy; no sklearn dependency in the gate itself)
# ---------------------------------------------------------------------------


def binary_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """ROC-AUC via the rank statistic (ties get average rank)."""
    scores, labels = np.asarray(scores, np.float64), np.asarray(labels)
    pos, neg = scores[labels == 1], scores[labels == 0]
    if not len(pos) or not len(neg):
        return float("nan")
    order = np.argsort(np.concatenate([pos, neg]), kind="stable")
    ranks = np.empty(len(order), np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    merged = np.concatenate([pos, neg])
    for v in np.unique(merged):
        tie = merged == v
        ranks[tie] = ranks[tie].mean()
    return float((ranks[: len(pos)].sum() - len(pos) * (len(pos) + 1) / 2) / (len(pos) * len(neg)))


def binary_mcc(pred_labels: np.ndarray, labels: np.ndarray) -> float:
    tp = int(((pred_labels == 1) & (labels == 1)).sum())
    tn = int(((pred_labels == 0) & (labels == 0)).sum())
    fp = int(((pred_labels == 1) & (labels == 0)).sum())
    fn = int(((pred_labels == 0) & (labels == 1)).sum())
    denom = np.sqrt(float(tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return float((tp * tn - fp * fn) / denom) if denom else 0.0


def classif_metrics(probs: np.ndarray, labels: np.ndarray) -> dict:
    probs, labels = np.asarray(probs, np.float64), np.asarray(labels, np.int64)
    pred = probs.argmax(axis=1)
    return {
        "accuracy": float((pred == labels).mean()),
        "auc": binary_auc(probs[:, 1], labels),
        "mcc": binary_mcc(pred, labels),
    }


def regress_metrics(pred: np.ndarray, target: np.ndarray) -> dict:
    pred, target = np.asarray(pred, np.float64), np.asarray(target, np.float64)
    mse = float(((pred - target) ** 2).mean())
    if pred.std() > 0 and target.std() > 0:
        r = float(np.corrcoef(pred, target)[0, 1])
    else:
        r = float("nan")
    return {"mse": mse, "pearson": r}


# ---------------------------------------------------------------------------
# Corpus assembly + featurization
# ---------------------------------------------------------------------------


def _hash01(key: str) -> float:
    """Deterministic pseudo-uniform in [0, 1) from a string key (no RNG state
    — both sides of the gate must see identical labels on any machine)."""
    import hashlib

    return int(hashlib.sha256(key.encode()).hexdigest()[:8], 16) / 0x100000000


# PPI-capable complexes in the reference test corpus beyond the 1ATN/3C8P
# referenced cases: (pdb dir, file, chains). They have no bound reference to
# score against, so they carry deterministic parity-only labels (the gate
# compares the two implementations on identical inputs; label semantics do
# not matter for that, only that the metrics de-saturate).
_EXTRA_COMPLEXES = [
    ("1A0Z", "1A0Z.pdb", ["A", "B"]),
    ("1A6B", "1A6B.pdb", ["A", "B"]),
    ("1ak4", "1ak4.pdb", ["C", "D"]),
    ("2g98", "2g98.pdb", ["A", "B"]),
    ("3MRC", "3MRC.pdb", ["M", "P"]),
    ("9api", "9api.pdb", ["A", "B"]),
]


def assemble_ppi_queries(data_dir: Path, resolution: str, decoy_dir: Path | None = None, decoys_per_complex: int = 25):
    """PPI queries: every 1ATN decoy (+3C8P bound complex) scored against its
    bound reference — real dockq/binary/irmsd targets via the port's
    StructureSimilarity (tools/target.py) — plus, when ``decoy_dir`` is
    given, ``decoys_per_complex`` generated rigid-body decoys per referenced
    complex (tools/decoys.py; graded perturbations, so irmsd sweeps ~0.2-11 Å
    and the binary labels split near 50/50), plus every other multi-chain
    complex in the corpus with deterministic parity-only labels (n = 55
    real-docking-labeled queries with decoys)."""
    from deeprank2_tpu_torch.query import ProteinProteinInterfaceQuery
    from deeprank2_tpu_torch.tools.target import compute_ppi_scores

    queries = []
    cases = [(data_dir / "pdb" / "1ATN" / f"1ATN_{i}w.pdb", data_dir / "ref" / "1ATN" / "1ATN.pdb") for i in range(1, 5)]
    cases.append((data_dir / "pdb" / "3C8P" / "3C8P.pdb", data_dir / "ref" / "3C8P" / "3C8P.pdb"))
    if decoy_dir is not None:
        from deeprank2_tpu_torch.tools.decoys import rigid_body_decoys

        for name in ("1ATN", "3C8P"):
            ref = data_dir / "ref" / name / f"{name}.pdb"
            if not ref.exists():
                continue
            for p in rigid_body_decoys(ref, "B", decoy_dir / name, count=decoys_per_complex, seed=7):
                cases.append((Path(p), ref))
    for pdb, ref in cases:
        if not pdb.exists() or not ref.exists():
            continue
        scores = compute_ppi_scores(str(pdb), str(ref))
        queries.append(
            ProteinProteinInterfaceQuery(
                pdb_path=str(pdb),
                resolution=resolution,
                chain_ids=["A", "B"],
                targets={k: scores[k] for k in ("binary", "dockq", "irmsd")},
            )
        )
    for name, fname, chains in _EXTRA_COMPLEXES:
        pdb = data_dir / "pdb" / name / fname
        if not pdb.exists():
            continue
        u = _hash01(f"ppi:{name}")
        queries.append(
            ProteinProteinInterfaceQuery(
                pdb_path=str(pdb),
                resolution=resolution,
                chain_ids=chains,
                targets={"binary": int(u < 0.5), "dockq": round(0.1 + 0.8 * u, 4), "irmsd": round(12.0 * _hash01(f"irmsd:{name}"), 4)},
            )
        )
    return queries


# SRV variant sources: every vendored PDB whose chains all carry PSSMs (the
# conservation feature needs a row for every node in the 10 Å neighborhood,
# which can span chains). (pdb relpath, {chain: pssm relpath}, variant chain).
_SRV_SOURCES = [
    ("pdb/101M/101M.pdb", {"A": "pssm/101M/101M.A.pdb.pssm"}, "A"),
    ("pdb/1ATN/1ATN_1w.pdb", {"A": "pssm/1ATN/1ATN.A.pdb.pssm", "B": "pssm/1ATN/1ATN.B.pdb.pssm"}, "A"),
    ("pdb/1ATN/1ATN_1w.pdb", {"A": "pssm/1ATN/1ATN.A.pdb.pssm", "B": "pssm/1ATN/1ATN.B.pdb.pssm"}, "B"),
    ("pdb/3C8P/3C8P.pdb", {"A": "pssm/3C8P/3C8P.A.pdb.pssm", "B": "pssm/3C8P/3C8P.B.pdb.pssm"}, "A"),
    ("pdb/3C8P/3C8P.pdb", {"A": "pssm/3C8P/3C8P.A.pdb.pssm", "B": "pssm/3C8P/3C8P.B.pdb.pssm"}, "B"),
    ("pdb/9api/9api.pdb", {"A": "pssm/9api/9api.A.pdb.pssm", "B": "pssm/9api/9api.B.pdb.pssm"}, "A"),
    ("pdb/1A0Z/1A0Z.pdb", {"A": "pssm/1A0Z/1A0Z.A.pdb.pssm", "B": "pssm/1A0Z/1A0Z.B.pdb.pssm"}, "A"),
]


def srv_severity(wildtype, variant, wt_conservation: float, var_conservation: float) -> float:
    """Deterministic physics-derived regression target for a substitution —
    a linear combination of exactly the signals the components/conservation
    feature modules write as per-node diff features (diff_charge, diff_size,
    diff_pI, diff_conservation; reference feature semantics
    deeprank2/features/components.py:42-63 and conservation.py:32-42), so a
    GNN that reads those features can genuinely learn it."""
    return float(
        0.2 * (wt_conservation - var_conservation)
        + 0.5 * (variant.charge - wildtype.charge)
        + (variant.size - wildtype.size) / 4.0
        + (variant.pI - wildtype.pI) / 4.0
    )


def assemble_srv_queries(data_dir: Path, per_source: int = 26):
    """SRV queries across ALL vendored PSSM-covered PDBs (seven
    chain-sources, ~180 variants): real wildtype amino acids read from the
    structures, variant amino acids cycled deterministically, and a
    physics-derived ``severity`` regression target (:func:`srv_severity`)
    plus its median-split ``binary`` label. Residues are skipped when the
    chain's PSSM lacks their row (the conservation module would reject the
    graph); the stride covers each chain end to end."""
    from deeprank2_tpu_torch.molstruct.aminoacid import amino_acids
    from deeprank2_tpu_torch.query import SingleResidueVariantQuery
    from deeprank2_tpu_torch.utils.buildgraph import get_structure
    from deeprank2_tpu_torch.utils.parsing.pssm import parse_pssm

    variant_cycle = [aa for aa in amino_acids if aa.three_letter_code in ("PHE", "TRP", "ASP", "LYS", "SER", "LEU", "GLY", "ARG", "VAL")]
    specs = []  # (pdb_path, pssm_paths, chain, number, icode, wildtype, variant, wt_cons, var_cons)
    for pdb_rel, pssm_rels, chain in _SRV_SOURCES:
        pdb_path = data_dir / pdb_rel
        pssm_paths = {c: data_dir / rel for c, rel in pssm_rels.items()}
        if not pdb_path.exists() or not all(p.exists() for p in pssm_paths.values()):
            continue
        arrays = get_structure(str(pdb_path))
        with open(pssm_paths[chain], encoding="utf-8") as f:
            table = parse_pssm(f)
        chain_idx = arrays.chain_ids.index(chain)
        res_indices = np.flatnonzero((arrays.res_chain == chain_idx) & (arrays.res_aa_ids >= 0))
        picked = 0
        for k in range(len(res_indices)):
            # golden-ratio stride covers the chain without clustering
            r = res_indices[int(k * 0.6180339887 * len(res_indices)) % len(res_indices)]
            number = int(arrays.res_numbers[r])
            icode = arrays.res_icodes[r]
            row = table.get(number, icode)
            if row is None:
                continue
            wildtype = amino_acids[int(arrays.res_aa_ids[r])]
            variant = variant_cycle[k % len(variant_cycle)]
            if variant is wildtype:
                variant = variant_cycle[(k + 1) % len(variant_cycle)]
            try:
                wt_cons = row.get_conservation(wildtype)
                var_cons = row.get_conservation(variant)
            except KeyError:
                continue
            if any(s[0] == pdb_path and s[2] == chain and s[3] == number for s in specs):
                continue  # one variant per residue position keeps ids unique
            specs.append((pdb_path, pssm_paths, chain, number, icode, wildtype, variant, wt_cons, var_cons))
            picked += 1
            if picked >= per_source:
                break

    severities = [srv_severity(wt, var, wc, vc) for *_, wt, var, wc, vc in specs]
    cut = float(np.median(severities))
    queries = []
    for (pdb_path, pssm_paths, chain, number, icode, wildtype, variant, wc, vc), sev in zip(specs, severities):
        queries.append(
            SingleResidueVariantQuery(
                pdb_path=str(pdb_path),
                resolution="residue",
                chain_ids=chain,
                variant_residue_number=number,
                insertion_code=icode,
                wildtype_amino_acid=wildtype,
                variant_amino_acid=variant,
                pssm_paths={c: str(p) for c, p in pssm_paths.items()},
                targets={"binary": int(sev > cut), "severity": round(sev, 6)},
            )
        )
    return queries


FLAVORS = ("ppi_residue", "ppi_atom", "ppi_grid", "srv_residue")
# conservation in the SRV flavor: the severity target's PSSM term must be
# visible to the models (diff_conservation at the variant node)
_MODULES = {"srv_residue": ["components", "contact", "conservation"]}


def _check_store(store: str) -> None:
    if store not in ("hdf5", "memory"):
        msg = f"store is 'hdf5' or 'memory', not {store!r}"
        raise ValueError(msg)


def featurize_queries(queries, flavor: str, work_dir: Path, store: str = "hdf5"):
    """Featurize ``queries`` as the corpus flavor ``flavor`` is featurized:
    its feature modules, and for ``ppi_grid`` a 12³ grid over 30 Å (fast
    Gaussian). ``store="hdf5"``: ``QueryCollection.process`` into
    ``work_dir/<flavor>.hdf5``, the JAX harness's route, which needs h5py;
    returns the path. ``store="memory"``: ``QueryCollection.
    process_in_memory``, every query built in this process; returns the
    ``MemoryStore``."""
    from deeprank2_tpu_torch.query import QueryCollection
    from deeprank2_tpu_torch.utils.grid import GridSettings, MapMethod

    _check_store(store)
    qc = QueryCollection()
    for q in queries:
        qc.add(q)
    kwargs = {"feature_modules": _MODULES.get(flavor, ["components", "contact"])}
    if flavor == "ppi_grid":
        kwargs.update(grid_settings=GridSettings([12, 12, 12], [30.0, 30.0, 30.0]), grid_map_method=MapMethod.FAST_GAUSSIAN)
    if store == "memory":
        return qc.process_in_memory(**kwargs)
    work_dir.mkdir(parents=True, exist_ok=True)
    path = work_dir / f"{flavor}.hdf5"
    paths = qc.process(prefix=str(work_dir / flavor), cpu_count=2, **kwargs)
    if Path(paths[0]) != path:
        os.rename(paths[0], path)
    return str(path)


def featurize_corpus(data_dir: Path, work_dir: Path, store: str = "hdf5", flavors=FLAVORS) -> dict:
    """Assemble and featurize the corpus flavors named
    (:func:`featurize_queries`), one dataset source each:
    ``{flavor: source}``. ``store="hdf5"`` caches by file presence and
    raises at once without h5py; ``store="memory"`` writes no file. The
    decoy PDBs go to ``work_dir/decoys`` either way."""
    _check_store(store)
    if store == "hdf5":
        import h5py  # noqa: F401 — the file route needs it; without it, raise here rather than after the assembly

    work_dir.mkdir(parents=True, exist_ok=True)
    decoy_dir = work_dir / "decoys"
    assemble = {
        "ppi_residue": lambda: assemble_ppi_queries(data_dir, "residue", decoy_dir),
        "ppi_atom": lambda: assemble_ppi_queries(data_dir, "atom", decoy_dir),
        "ppi_grid": lambda: assemble_ppi_queries(data_dir, "residue", decoy_dir),
        "srv_residue": lambda: assemble_srv_queries(data_dir),
    }
    out: dict = {}
    for name in flavors:
        path = work_dir / f"{name}.hdf5"
        out[name] = str(path) if store == "hdf5" and path.exists() else featurize_queries(assemble[name](), name, work_dir, store)
    return out


# ---------------------------------------------------------------------------
# Torch mirrors of the reference models (compact batches, reference math)
# ---------------------------------------------------------------------------


def _t(x, requires_grad=False):
    import torch

    t = torch.tensor(np.asarray(x, dtype=np.float32))
    if requires_grad:
        t.requires_grad_(True)
    return t


def _compact_batch(entries: list[dict], need_clusters: bool):
    """Concatenate entry dicts the reference/PyG way (mirrored edges, global
    cluster ids); returns plain numpy arrays."""
    xs, rows, cols, eattrs, ngraph = [], [], [], [], []
    c0_list, c1_list, graph_of_c0 = [], [], []
    v_off = c0_off = c1_off = 0
    ys = []
    for g, e in enumerate(entries):
        v = e["x"].shape[0]
        xs.append(np.asarray(e["x"], dtype=np.float32))
        und = np.asarray(e["edge_index"], dtype=np.int64)
        rows.append(np.concatenate([und[:, 0], und[:, 1]]) + v_off)
        cols.append(np.concatenate([und[:, 1], und[:, 0]]) + v_off)
        ea = np.asarray(e["edge_attr"], dtype=np.float32).reshape(len(und), -1)
        eattrs.append(np.concatenate([ea, ea], axis=0))
        ngraph.append(np.full(v, g))
        ys.append(e["y"])
        if need_clusters:
            c0 = np.asarray(e["cluster0"], dtype=np.int64)
            c1 = np.asarray(e["cluster1"], dtype=np.int64)
            n_c0, n_c1 = int(c0.max()) + 1, int(c1.max()) + 1
            c0_list.append(c0 + c0_off)
            c1_list.append(c1 + c1_off)
            graph_of_c0.append(np.full(n_c0, g))
            c0_off, c1_off = c0_off + n_c0, c1_off + n_c1
        v_off += v
    batch = {
        "x": np.concatenate(xs),
        "row": np.concatenate(rows),
        "col": np.concatenate(cols),
        "edge_attr": np.concatenate(eattrs),
        "node_graph": np.concatenate(ngraph),
        "y": np.asarray(ys, dtype=np.float64),
        "num_graphs": len(entries),
    }
    if need_clusters:
        batch.update(
            c0=np.concatenate(c0_list),
            c1=np.concatenate(c1_list),
            graph_c0=np.concatenate(graph_of_c0),
            num_c0=c0_off,
            num_c1=c1_off,
        )
        pi, pj = batch["c0"][batch["row"]], batch["c0"][batch["col"]]
        keep = pi != pj
        pooled, idx = np.unique(np.stack([pi[keep], pj[keep]], axis=1), axis=0, return_index=True)
        batch["pooled_row"], batch["pooled_col"] = pooled[:, 0], pooled[:, 1]
        # coalesced pooled edge attrs = SUM over member edges (PyG coalesce)
        key = pi[keep] * batch["num_c0"] + pj[keep]
        order = np.argsort(key, kind="stable")
        uniq, inverse = np.unique(key[order], return_inverse=True)
        summed = np.zeros((len(uniq), batch["edge_attr"].shape[1]), dtype=np.float64)
        np.add.at(summed, inverse, batch["edge_attr"][keep][order])
        # uniq keys sort identically to np.unique(pairs) rows
        batch["pooled_attr"] = summed.astype(np.float32)
    return batch


def _scatter_sum(src, idx, num):
    import torch

    out = torch.zeros(num, src.shape[1], dtype=src.dtype)
    return out.index_add_(0, idx, src)


def _scatter_mean(src, idx, num):
    import torch

    sums = _scatter_sum(src, idx, num)
    counts = torch.zeros(num, dtype=src.dtype).index_add_(0, idx, torch.ones(len(idx), dtype=src.dtype))
    return sums / counts.clamp(min=1.0)[:, None]


def _scatter_amax(src, idx, num):
    import torch

    out = torch.full((num, src.shape[1]), -torch.inf, dtype=src.dtype)
    return out.index_reduce_(0, idx, src, "amax", include_self=False)


class TorchMirror:
    """Reference-pipeline forward passes sharing the port's initial parameters.

    ``params`` is the JAX-layout tree (``neuralnets/param_interop.py:
    params_to_jax`` of the port's state dict). Parameter tensors are
    registered CPU leaves driven by torch.optim.Adam with the Trainer's
    defaults; forwards mirror deeprank2/neuralnets/* math in float32."""

    def __init__(self, kind: str, params, task: str):
        import torch

        self.kind = kind
        self.task = task
        self.tp: dict = {}
        p = params
        if kind in ("ginet", "ginet_nocluster"):
            for tower in ("conv1", "conv2", "conv1_ext", "conv2_ext"):
                self.tp[tower] = _t(p[tower]["fc"]["w"], True)
            for fc in ("fc1", "fc2"):
                self.tp[fc + ".w"] = _t(p[fc]["w"], True)
                self.tp[fc + ".b"] = _t(p[fc]["b"], True)
        elif kind == "fout":
            for conv in ("conv1", "conv2"):
                self.tp[conv + ".wc"] = _t(p[conv]["wc"], True)
                self.tp[conv + ".wn"] = _t(p[conv]["wn"], True)
                self.tp[conv + ".b"] = _t(p[conv]["b"], True)
            for fc in ("fc1", "fc2"):
                self.tp[fc + ".w"] = _t(p[fc]["w"], True)
                self.tp[fc + ".b"] = _t(p[fc]["b"], True)
        elif kind == "sgat":
            for conv in ("conv1", "conv2"):
                self.tp[conv + ".weight"] = _t(p[conv]["weight"], True)
                self.tp[conv + ".b"] = _t(p[conv]["b"], True)
            for fc in ("fc1", "fc2"):
                self.tp[fc + ".w"] = _t(p[fc]["w"], True)
                self.tp[fc + ".b"] = _t(p[fc]["b"], True)
        elif kind == "vanilla":
            for layer in ("external1", "external2"):
                for mlp in ("edge_mlp", "node_mlp"):
                    self.tp[f"{layer}.{mlp}.w"] = _t(p[layer][mlp]["w"], True)
                    self.tp[f"{layer}.{mlp}.b"] = _t(p[layer][mlp]["b"], True)
            self.tp["fc1.w"] = _t(p["graph_mlp"]["fc1"]["w"], True)
            self.tp["fc1.b"] = _t(p["graph_mlp"]["fc1"]["b"], True)
            self.tp["fc2.w"] = _t(p["graph_mlp"]["fc2"]["w"], True)
            self.tp["fc2.b"] = _t(p["graph_mlp"]["fc2"]["b"], True)
        elif kind == "cnn":
            for name in ("conv000", "conv002", "fc000", "fc001"):
                self.tp[name + ".w"] = _t(p[name]["w"], True)
                self.tp[name + ".b"] = _t(p[name]["b"], True)
        else:
            msg = f"unknown mirror kind {kind}"
            raise ValueError(msg)
        self.opt = torch.optim.Adam(self.tp.values(), lr=1e-3, weight_decay=1e-5)

    # --- conv building blocks -------------------------------------------
    def _ginet_tower(self, b, w1, w2):
        import torch

        x = _t(b["x"])
        row, col = torch.tensor(b["row"]), torch.tensor(b["col"])
        h = torch.relu(_scatter_sum((x @ w1)[col], row, x.shape[0]))
        hp = _scatter_amax(h, torch.tensor(b["c0"]), b["num_c0"])
        prow, pcol = torch.tensor(b["pooled_row"]), torch.tensor(b["pooled_col"])
        h2 = torch.relu(_scatter_sum((hp @ w2)[pcol], prow, b["num_c0"]))
        hq = _scatter_amax(h2, torch.tensor(b["c1"]), b["num_c1"])
        graph_c1 = torch.zeros(b["num_c1"], dtype=torch.int64)
        graph_c1.index_copy_(0, torch.tensor(b["c1"]), torch.tensor(b["graph_c0"]))
        return _scatter_mean(hq, graph_c1, b["num_graphs"])

    def _fout_conv(self, b, prefix, x, row, col, num_v):
        alpha = x @ self.tp[prefix + ".wc"]
        beta = x @ self.tp[prefix + ".wn"]
        gamma = _scatter_mean(beta[col], row, num_v)
        return alpha + gamma + self.tp[prefix + ".b"]

    def _sgat_conv(self, b, prefix, x, row, col, ea, num_v):
        import torch

        w = self.tp[prefix + ".weight"]
        alpha = torch.cat([x[row], x[col]], dim=1) @ w
        alpha = ea[:, :1] * alpha  # scalar edge channel broadcast (sgat.py:77)
        return _scatter_mean(alpha, row, num_v) + self.tp[prefix + ".b"]

    def _clustered_forward(self, b, conv):
        import torch

        x = _t(b["x"])
        row, col = torch.tensor(b["row"]), torch.tensor(b["col"])
        ea = _t(b["edge_attr"])
        h = torch.relu(conv("conv1", x, row, col, ea, x.shape[0]))
        hp = _scatter_amax(h, torch.tensor(b["c0"]), b["num_c0"])
        prow, pcol = torch.tensor(b["pooled_row"]), torch.tensor(b["pooled_col"])
        pea = _t(b["pooled_attr"])
        h2 = torch.relu(conv("conv2", hp, prow, pcol, pea, b["num_c0"]))
        hq = _scatter_amax(h2, torch.tensor(b["c1"]), b["num_c1"])
        graph_c1 = torch.zeros(b["num_c1"], dtype=torch.int64)
        graph_c1.index_copy_(0, torch.tensor(b["c1"]), torch.tensor(b["graph_c0"]))
        pooled = _scatter_mean(hq, graph_c1, b["num_graphs"])
        h = torch.relu(pooled @ self.tp["fc1.w"] + self.tp["fc1.b"])
        return h @ self.tp["fc2.w"] + self.tp["fc2.b"]

    # --- model forwards --------------------------------------------------
    def forward(self, b) -> object:
        import torch

        if self.kind == "ginet":
            emb = torch.cat(
                [self._ginet_tower(b, self.tp["conv1"], self.tp["conv2"]), self._ginet_tower(b, self.tp["conv1_ext"], self.tp["conv2_ext"])],
                dim=1,
            )
            h = torch.relu(emb @ self.tp["fc1.w"] + self.tp["fc1.b"])
            return h @ self.tp["fc2.w"] + self.tp["fc2.b"]
        if self.kind == "ginet_nocluster":
            x = _t(b["x"])
            row, col = torch.tensor(b["row"]), torch.tensor(b["col"])
            ngraph = torch.tensor(b["node_graph"])

            def tower(w1, w2):
                h = torch.relu(_scatter_sum((x @ w1)[col], row, x.shape[0]))
                h = torch.relu(_scatter_sum((h @ w2)[col], row, x.shape[0]))
                return _scatter_mean(h, ngraph, b["num_graphs"])

            emb = torch.cat([tower(self.tp["conv1"], self.tp["conv2"]), tower(self.tp["conv1_ext"], self.tp["conv2_ext"])], dim=1)
            h = torch.relu(emb @ self.tp["fc1.w"] + self.tp["fc1.b"])
            return h @ self.tp["fc2.w"] + self.tp["fc2.b"]
        if self.kind == "fout":
            return self._clustered_forward(b, lambda pre, x, row, col, ea, n: self._fout_conv(b, pre, x, row, col, n))
        if self.kind == "sgat":
            return self._clustered_forward(b, lambda pre, x, row, col, ea, n: self._sgat_conv(b, pre, x, row, col, ea, n))
        if self.kind == "vanilla":
            x = _t(b["x"])
            row, col = torch.tensor(b["row"]), torch.tensor(b["col"])
            ea = _t(b["edge_attr"])

            def conv(layer, h):
                msg_in = torch.cat([h[row], h[col], ea], dim=1)
                msg = torch.relu(msg_in @ self.tp[f"{layer}.edge_mlp.w"] + self.tp[f"{layer}.edge_mlp.b"])
                sums = _scatter_sum(msg, row, h.shape[0])
                return torch.relu(torch.cat([h, sums], dim=1) @ self.tp[f"{layer}.node_mlp.w"] + self.tp[f"{layer}.node_mlp.b"])

            h = conv("external2", conv("external1", x))
            means = _scatter_mean(h, torch.tensor(b["node_graph"]), b["num_graphs"])
            h = torch.relu(means @ self.tp["fc1.w"] + self.tp["fc1.b"])
            return h @ self.tp["fc2.w"] + self.tp["fc2.b"]
        if self.kind == "cnn":
            f = torch.nn.functional
            h = torch.relu(f.conv3d(_t(b["x"]), self.tp["conv000.w"], self.tp["conv000.b"]))
            h = f.max_pool3d(h, 2)
            h = torch.relu(f.conv3d(h, self.tp["conv002.w"], self.tp["conv002.b"]))
            h = f.max_pool3d(h, 2)
            h = h.reshape(h.shape[0], -1)
            h = torch.relu(h @ self.tp["fc000.w"] + self.tp["fc000.b"])
            return h @ self.tp["fc001.w"] + self.tp["fc001.b"]
        raise AssertionError(self.kind)

    def loss(self, logits, y):
        import torch

        if self.task == "classif":
            return torch.nn.functional.cross_entropy(logits, torch.tensor(y.astype(np.int64)))
        return torch.nn.functional.mse_loss(logits.reshape(-1), torch.tensor(y.astype(np.float32)))

    def train_pass(self, chunks) -> tuple[float, np.ndarray]:
        """One epoch over the chunks (predictions logged pre-update, like the
        Trainer's training pass); returns (weighted mean loss, outputs)."""
        losses, counts, outs = [], [], []
        for b in chunks:
            logits = self.forward(b)
            loss = self.loss(logits, b["y"])
            self.opt.zero_grad()
            loss.backward()
            self.opt.step()
            losses.append(float(loss.detach()))
            counts.append(b["num_graphs"])
            outs.append(logits.detach().numpy())
        total = sum(c for c in counts)
        mean = sum(lo * c for lo, c in zip(losses, counts)) / total
        return mean, np.concatenate(outs)

    def eval_pass(self, chunks) -> tuple[float, np.ndarray]:
        import torch

        losses, counts, outs = [], [], []
        with torch.no_grad():
            for b in chunks:
                logits = self.forward(b)
                losses.append(float(self.loss(logits, b["y"])))
                counts.append(b["num_graphs"])
                outs.append(logits.numpy())
        total = sum(counts)
        return sum(lo * c for lo, c in zip(losses, counts)) / total, np.concatenate(outs)


def _log_probs(probs: np.ndarray) -> np.ndarray:
    """The log of exported probabilities: the logits' order back (the
    metrics need only ranking and argmax); an underflowed 0 gives -inf."""
    with np.errstate(divide="ignore"):
        return np.log(np.asarray(probs, np.float64))


def _as_exported(logits: np.ndarray) -> np.ndarray:
    """Logits as the port's side reads them back: the Trainer exports each
    graph's softmax probabilities computed in float32
    (``Trainer._export_outputs``), read through :func:`_log_probs`. A
    saturated float32 softmax ties its probabilities at 1.0; the mirror's
    logits take the same readout, so that both sides' metrics see the same
    ties."""
    z = np.asarray(logits, np.float32)
    p = np.exp(z - z.max(axis=1, keepdims=True))
    return _log_probs(p / p.sum(axis=1, keepdims=True))


def _outputs_to_metrics(task: str, outputs: np.ndarray, y: np.ndarray) -> dict:
    if task == "classif":
        z = outputs - outputs.max(axis=1, keepdims=True)
        probs = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
        return classif_metrics(probs, y)
    return regress_metrics(outputs.reshape(-1), y)


class PassRecorder:
    """An output exporter of the Trainer that keeps every pass in memory:
    its name, epoch, entry names, outputs (softmax probabilities for
    classification, as the Trainer exports them), targets and loss. It
    stands where the JAX harness reads ``HDF5OutputExporter`` back through
    pandas, on machines with neither."""

    def __init__(self):
        self.passes: list[dict] = []

    def __enter__(self):
        return self

    def __exit__(self, *exc_info) -> None:
        pass

    def is_compatible_with(self, output_data_shape, target_data_shape=None) -> bool:  # noqa: ARG002
        return True

    def process(self, pass_name, epoch_number, entry_names, output_values, target_values, loss) -> None:
        self.passes.append(
            {
                "pass": pass_name,
                "epoch": epoch_number,
                "names": list(entry_names),
                "outputs": np.array([np.atleast_1d(o) for o in output_values]),
                "targets": np.asarray(target_values, np.float64),
                "loss": loss,
            }
        )

    def get(self, pass_name: str, epoch: int) -> dict:
        """The (last) record of ``pass_name`` at ``epoch``."""
        return next(p for p in reversed(self.passes) if p["pass"] == pass_name and p["epoch"] == epoch)


def _kernel_launches() -> dict:
    """The port's kernel launch counters, by kernel."""
    from deeprank2_tpu_torch.parallel.probes import launches

    return launches()["by_kernel"]


def _launch_delta(before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in _kernel_launches().items() if n - before.get(k, 0)}


# ---------------------------------------------------------------------------
# Config runners
# ---------------------------------------------------------------------------

CONFIG_NAMES = (
    "vanilla_srv_regress",
    "vanilla_srv_classif",
    "ginet_ppi_classif",
    "ginet_dense_diag_classif",
    "ginet_bcsr_classif",
    "vanilla_blocked_classif",
    "ginet_clustered_bcsr_classif",
    "ginet_clustered_diag_classif",
    "fout_atom_classif",
    "sgat_atom_classif",
    "cnn_grid_classif",
    "ginet_edgepart_ba",
)

# the corpus flavor each configuration trains on
CONFIG_FLAVORS = {
    "vanilla_srv_regress": "srv_residue",
    "vanilla_srv_classif": "srv_residue",
    "ginet_ppi_classif": "ppi_residue",
    "ginet_dense_diag_classif": "ppi_residue",
    "ginet_bcsr_classif": "ppi_atom",
    "vanilla_blocked_classif": "ppi_atom",
    "ginet_clustered_bcsr_classif": "ppi_residue",
    "ginet_clustered_diag_classif": "ppi_residue",
    "fout_atom_classif": "ppi_atom",
    "sgat_atom_classif": "ppi_atom",
    "cnn_grid_classif": "ppi_grid",
    "ginet_edgepart_ba": "ppi_residue",
}


def _make_chunks(entries: list[dict], batch_size: int, grid: bool, clustered: bool) -> list[dict]:
    chunks_entries = [entries[i : i + batch_size] for i in range(0, len(entries), batch_size)]
    if grid:
        return [
            {"x": np.stack([e["x"] for e in ch]), "y": np.asarray([e["y"] for e in ch], np.float64), "num_graphs": len(ch)}
            for ch in chunks_entries
        ]
    return [_compact_batch(ch, need_clusters=clustered) for ch in chunks_entries]


def make_datasets(source, *, target: str, task: str, clustered: bool, grid: bool, ds_kwargs: dict, train_names=None, val_names=None) -> tuple:
    """``(train, val)``: the datasets a run trains and validates on, from
    ``source`` (a file path or a ``MemoryStore``). A clustered graph
    configuration names the ``mcl`` clusters, and gets an explicit
    validation set even without ``val_names``, which keeps the Trainer from
    splitting the training set (determinism first)."""
    from deeprank2_tpu_torch.dataset import GraphDataset, GridDataset

    ds_cls = GridDataset if grid else GraphDataset
    kwargs = dict(ds_kwargs)
    cluster_kwargs = {"clustering_method": "mcl"} if clustered and not grid else {}
    if train_names is not None:
        kwargs["subset"] = train_names
    ds_train = ds_cls(hdf5_path=source, target=target, task=task, **kwargs, **cluster_kwargs)
    if val_names is not None:
        return ds_train, ds_cls(hdf5_path=source, train_source=ds_train, subset=val_names, **cluster_kwargs)
    if cluster_kwargs:
        return ds_train, ds_cls(hdf5_path=source, train_source=ds_train, **cluster_kwargs)
    return ds_train, None


def _run_fold(
    source,
    *,
    model_cls,
    mirror_kind: str,
    task: str,
    target: str,
    epochs: int,
    batch_size: int,
    clustered: bool,
    grid: bool,
    ds_kwargs: dict,
    train_names: list[str] | None,
    val_names: list[str] | None,
    device,
    initial_params: dict | None,
    optimizer,
) -> dict:
    """One train (+optional held-out) run: the port's Trainer against the
    torch mirror on identical batches; per-epoch training loss and held-out
    metric trajectories for both sides. ``source`` is a file path or a
    ``MemoryStore``; ``initial_params`` (the JAX layout) replaces the
    Trainer's own initialization when given; ``optimizer`` is the Trainer's
    optimizer class."""
    import torch

    from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax, params_to_jax
    from deeprank2_tpu_torch.trainer import Trainer, _param_family
    from deeprank2_tpu_torch.utils.exporters import OutputExporterCollection

    ds_train, ds_val = make_datasets(source, target=target, task=task, clustered=clustered, grid=grid, ds_kwargs=ds_kwargs, train_names=train_names, val_names=val_names)
    validate = val_names is not None

    recorder = PassRecorder()
    trainer = Trainer(model_cls, dataset_train=ds_train, dataset_val=ds_val, output_exporters=[recorder], seed=7, device=device)
    family = _param_family(model_cls)
    if initial_params is not None:
        trainer.model.load_state_dict({k: torch.as_tensor(v) for k, v in params_from_jax(initial_params, family).items()})
    trainer.configure_optimizers(optimizer)

    # the mirror shares the initial parameters and the exact chunks
    entries = [ds_train.get(i) for i in range(len(ds_train))]
    chunks = _make_chunks(entries, batch_size, grid, clustered)
    val_chunks = None
    if validate:
        val_entries = [ds_val.get(i) for i in range(len(ds_val))]
        val_chunks = _make_chunks(val_entries, batch_size, grid, clustered)
    mirror = TorchMirror(mirror_kind, params_to_jax(trainer.model.state_dict(), family), task)

    trainer.train(nepoch=epochs, batch_size=batch_size, shuffle=False, validate=validate, best_model=False, filename=None)

    # ---- the port's trajectories from the recorder (the exporter keeps
    # softmax probabilities for classification) ----
    port_losses = [float(recorder.get("training", e)["loss"]) for e in range(1, epochs + 1)]
    last = recorder.get("training", epochs)
    outputs = last["outputs"]
    port_metrics = _outputs_to_metrics(task, _log_probs(outputs) if task == "classif" else outputs, last["targets"])

    port_val_traj, port_val_out, val_y = [], None, None
    if validate:
        for e in range(1, epochs + 1):
            rows = recorder.get("validation", e)
            vo, vy = rows["outputs"], rows["targets"]
            port_val_traj.append(_outputs_to_metrics(task, _log_probs(vo) if task == "classif" else vo, vy))
        # final-epoch held-out logits for pooled CV metrics
        port_val_out = _log_probs(vo) if task == "classif" else vo
        val_y = vy

    # ---- mirror trajectories (train epoch, then held-out eval — the same
    # order the Trainer runs) ----
    mirror_losses, mirror_val_traj = [], []
    mirror_out = mirror_val_out = None
    for _ in range(epochs):
        loss, mirror_out = mirror.train_pass(chunks)
        mirror_losses.append(loss)
        if validate:
            _, mirror_val_out = mirror.eval_pass(val_chunks)
            if task == "classif":
                mirror_val_out = _as_exported(mirror_val_out)
            vy_m = np.concatenate([c["y"] for c in val_chunks])
            mirror_val_traj.append(_outputs_to_metrics(task, mirror_val_out, vy_m))
    y_all = np.concatenate([c["y"] for c in chunks])
    mirror_metrics = _outputs_to_metrics(task, _as_exported(mirror_out) if task == "classif" else mirror_out, y_all)

    # ---- synced single-epoch probe: restart BOTH sides from the same
    # (end-of-training) parameters with fresh optimizer state and compare
    # exactly one epoch. Free-running trajectories on learnable targets
    # diverge chaotically (rounding differences compound through relu/Adam
    # dynamics); this probe separates the two: an implementation
    # disagreement shows up here, chaos cannot. ----
    probe_mirror = TorchMirror(mirror_kind, params_to_jax(trainer.model.state_dict(), family), task)
    trainer.configure_optimizers(optimizer)
    # the probe writes to its own recorder, so the run's passes stay as they were
    probe_recorder = PassRecorder()
    saved_exporters = trainer._output_exporters
    trainer._output_exporters = OutputExporterCollection(probe_recorder)
    try:
        trainer.train(nepoch=1, batch_size=batch_size, shuffle=False, validate=False, best_model=False, filename=None)
    finally:
        trainer._output_exporters = saved_exporters
    probe_loss_port = float(probe_recorder.get("training", 1)["loss"])
    probe_loss_mirror, _ = probe_mirror.train_pass(chunks)
    synced_rel = abs(probe_loss_port - probe_loss_mirror) / max(abs(probe_loss_port), abs(probe_loss_mirror), 1.0)

    return {
        "entries": len(entries),
        "synced_epoch_rel_delta": float(synced_rel),
        "synced_loss_port": probe_loss_port,
        "synced_loss_mirror": probe_loss_mirror,
        "loss_port": port_losses,
        "loss_mirror": mirror_losses,
        "max_loss_delta": float(max(abs(a - b) for a, b in zip(port_losses, mirror_losses))),
        # relative form: configs whose training transiently explodes (losses
        # ~1e11) make the absolute delta meaningless while the sides still
        # track each other to ~1e-5 relative
        "max_loss_delta_rel": float(max(abs(a - b) / max(abs(a), abs(b), 1.0) for a, b in zip(port_losses, mirror_losses))),
        "metrics_port": port_metrics,
        "metrics_mirror": mirror_metrics,
        "val_traj_port": port_val_traj,
        "val_traj_mirror": mirror_val_traj,
        "val_out_port": port_val_out,
        "val_out_mirror": mirror_val_out,
        "val_y": val_y,
    }


def run_trainer_config(
    name: str,
    source,
    *,
    model_cls,
    mirror_kind: str,
    task: str,
    target: str,
    epochs: int,
    batch_size: int,
    clustered: bool,
    dataset_kwargs: dict | None = None,
    grid: bool = False,
    folds: int = 0,
    device=None,
    initial_params: dict | None = None,
    optimizer=None,
) -> dict:
    """Train via the port's Trainer (shuffle off) and the torch mirror on
    identical batches; return the trajectory/metric comparison, with the
    run's seconds and its kernel launches by kernel (``launches``).

    ``source`` is an HDF5 path or a ``MemoryStore``; ``device`` the
    Trainer's (CUDA unless ``"cpu"``); ``optimizer`` its optimizer class
    (:func:`_optimizer`). ``folds >= 2`` runs k-fold
    cross-validation: every fold's held-out metric trajectory is recorded
    on both sides, and the headline metrics pool each entry's final-epoch
    prediction from the fold that held it out.
    """
    t0, before = time.perf_counter(), _kernel_launches()
    ds_kwargs = dict(dataset_kwargs or {})
    common = dict(
        model_cls=model_cls,
        mirror_kind=mirror_kind,
        task=task,
        target=target,
        epochs=epochs,
        batch_size=batch_size,
        clustered=clustered,
        grid=grid,
        ds_kwargs=ds_kwargs,
        device=device,
        initial_params=initial_params,
        optimizer=_optimizer(optimizer),
    )
    if folds < 2:  # noqa: PLR2004
        r = _run_fold(source, train_names=None, val_names=None, **common)
        report = {"config": name, "task": task, "epochs": epochs, **{k: v for k, v in r.items() if not k.startswith("val_")}}
        return {**report, "seconds": time.perf_counter() - t0, "launches": _launch_delta(before)}

    probe, _ = make_datasets(source, target=target, task=task, clustered=clustered, grid=grid, ds_kwargs=ds_kwargs)
    names = [probe.get(i)["entry_name"] for i in range(len(probe))]

    fold_reports = []
    pooled = {"port": [], "mirror": [], "y": []}
    for f in range(folds):
        val_names = names[f::folds]
        train_names = [n for n in names if n not in val_names]
        r = _run_fold(source, train_names=train_names, val_names=val_names, **common)
        fold_reports.append(r)
        pooled["port"].append(r["val_out_port"])
        pooled["mirror"].append(r["val_out_mirror"])
        pooled["y"].append(r["val_y"])

    cv_port = _outputs_to_metrics(task, np.concatenate(pooled["port"]), np.concatenate(pooled["y"]))
    cv_mirror = _outputs_to_metrics(task, np.concatenate(pooled["mirror"]), np.concatenate(pooled["y"]))
    max_metric_delta = 0.0
    for r in fold_reports:
        for mp, mm in zip(r["val_traj_port"], r["val_traj_mirror"]):
            for k in mp:
                if np.isfinite(mp[k]) and np.isfinite(mm[k]):
                    max_metric_delta = max(max_metric_delta, abs(mp[k] - mm[k]))
    return {
        "config": name,
        "task": task,
        "entries": len(names),
        "epochs": epochs,
        "folds": folds,
        "max_loss_delta": float(max(r["max_loss_delta"] for r in fold_reports)),
        "max_loss_delta_rel": float(max(r["max_loss_delta_rel"] for r in fold_reports)),
        "synced_epoch_rel_delta": float(max(r["synced_epoch_rel_delta"] for r in fold_reports)),
        "max_val_metric_delta": float(max_metric_delta),
        "metrics_port": cv_port,
        "metrics_mirror": cv_mirror,
        "val_traj_port": [r["val_traj_port"] for r in fold_reports],
        "val_traj_mirror": [r["val_traj_mirror"] for r in fold_reports],
        "loss_port": [r["loss_port"] for r in fold_reports],
        "loss_mirror": [r["loss_mirror"] for r in fold_reports],
        "seconds": time.perf_counter() - t0,
        "launches": _launch_delta(before),
    }


def edgepart_rank(rank: int, world: int, spec: dict) -> dict:
    """One rank of :func:`run_edgepart_config` (for ``parallel/launch.py``,
    or called in process with ``world=1``): the no-cluster GINet (BA
    regression head) trained ``spec["epochs"]`` full-batch Adam steps through
    the edge-partitioned forward on this rank's part of
    ``collate_graphs(spec["entries"])``, the MSE loss of every graph on
    every rank and the gradients pmean'ed (``dp.sync_gradients``), stepped
    by ``ops.optim.<spec["optimizer"]>``. Returns the pre-update losses,
    the post-update predictions, the initial state (host copies) and the
    kernels launched over the run."""
    import torch

    from deeprank2_tpu_torch.neuralnets.gnn.ginet_nocluster import GINet
    from deeprank2_tpu_torch.ops import optim
    from deeprank2_tpu_torch.ops.batch import collate_graphs
    from deeprank2_tpu_torch.parallel import cluster, dp
    from deeprank2_tpu_torch.parallel import edge_partition as ep

    dev = cluster.rank_device(spec["device"])
    entries = spec["entries"]
    batch, _ = collate_graphs(entries, device="cpu")
    part = ep.partition_graph_batch(batch.to(dev), world)[rank]
    model = GINet(batch.x.shape[1], 1, batch.edge_attr.shape[1], device=dev, generator=torch.Generator().manual_seed(7))
    if spec.get("state") is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in spec["state"].items()})
    initial = {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}
    forward = ep.make_edge_partitioned_ginet_forward(model)
    optimizer = getattr(optim, spec["optimizer"])(model.parameters(), lr=1e-3, weight_decay=1e-5)
    params = list(model.parameters())
    n_real = len(entries)
    y = torch.as_tensor(np.asarray([e["y"] for e in entries], np.float32), device=dev)

    before = _kernel_launches()
    losses = []
    for _ in range(spec["epochs"]):
        optimizer.zero_grad(set_to_none=True)
        pred = forward(part)[:n_real, 0]
        loss = ((pred - y) ** 2).mean()
        loss.backward()
        dp.sync_gradients(params, loss)
        optimizer.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        pred = forward(part)[:n_real, 0].cpu().numpy()
    return {"losses": losses, "pred": pred, "initial": initial, "launches": _launch_delta(before), "device": str(dev)}


def run_edgepart_config(source, *, epochs: int, dataset_kwargs: dict | None = None, device=None, ranks: int = 1, initial_params: dict | None = None, optimizer=None) -> dict:
    """GINet BA (dockq) regression through the edge-partitioned
    graph-parallel forward over ``ranks`` ranks (in this process for one,
    else spawned by ``parallel/launch.py`` over gloo), against the plain
    torch mirror (the partitioned program computes the same global math).
    ``initial_params`` (the JAX layout) replaces the model's own
    initialization when given; ``optimizer`` is as
    :func:`run_trainer_config`'s. Reports rank 0's launches."""
    import torch

    from deeprank2_tpu_torch.dataset import GraphDataset
    from deeprank2_tpu_torch.neuralnets.param_interop import params_from_jax, params_to_jax
    from deeprank2_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    ds = GraphDataset(hdf5_path=source, target="dockq", task="regress", **(dataset_kwargs or {}))
    entries = [ds.get(i) for i in range(len(ds))]
    y = np.asarray([e["y"] for e in entries], np.float64)
    spec = {"entries": entries, "epochs": epochs, "device": "cuda" if device is None else str(device), "optimizer": _optimizer(optimizer).__name__}
    if initial_params is not None:
        spec["state"] = {k: v.numpy() for k, v in params_from_jax(initial_params).items()}
    res = edgepart_rank(0, 1, spec) if ranks == 1 else launch.run(edgepart_rank, ranks, spec, deadline=600.0)[0]

    mirror = TorchMirror("ginet_nocluster", params_to_jax({k: torch.as_tensor(v) for k, v in res["initial"].items()}), "regress")
    chunk = _compact_batch(entries, need_clusters=False)
    torch_losses = [mirror.train_pass([chunk])[0] for _ in range(epochs)]
    port_losses = res["losses"]
    # final metrics: post-update predictions on BOTH sides
    _, out = mirror.eval_pass([chunk])
    return {
        "config": "ginet_edgepart_ba",
        "task": "regress",
        "entries": len(entries),
        "epochs": epochs,
        "shards": ranks,
        "loss_port": port_losses,
        "loss_mirror": torch_losses,
        "max_loss_delta": float(max(abs(a - b) for a, b in zip(port_losses, torch_losses))),
        "max_loss_delta_rel": float(max(abs(a - b) / max(abs(a), abs(b), 1.0) for a, b in zip(port_losses, torch_losses))),
        "metrics_port": regress_metrics(res["pred"], y),
        "metrics_mirror": regress_metrics(out.reshape(-1), y),
        "seconds": time.perf_counter() - t0,
        "launches": res["launches"],
    }


def _optimizer(optimizer):
    """The Trainer's optimizer class: ``ops/optim.py:ReferenceAdam`` unless
    given. The mirror steps with ``torch.optim.Adam``, the reference's;
    the port's default ``Adam`` rounds its bias corrections as JAX does, a
    6e-6 difference in the first step that the SRV regression's two epochs
    amplify to 5e-3 from the port's initialization."""
    from deeprank2_tpu_torch.ops import optim

    return optim.ReferenceAdam if optimizer is None else optimizer


def _no_dropout(cls):
    """``cls`` with dropout off, so the mirror is step-for-step
    deterministic (the port's models read the class attribute)."""
    return type(cls.__name__, (cls,), {"dropout": 0.0, "__doc__": f"{cls.__name__} without dropout, for the parity gate."})


def config_table() -> dict:
    """Every configuration: ``name -> (model class, mirror kind, task,
    target, batch size, clustered, dataset kwargs, grid)``, the models with
    dropout off (``ginet_edgepart_ba``'s model is the edge-partitioned
    no-cluster GINet of :func:`edgepart_rank`)."""
    from deeprank2_tpu_torch.neuralnets.cnn.model3d import CnnClassification
    from deeprank2_tpu_torch.neuralnets.gnn.clustered_blocksparse import GINetClusteredBlockSparse
    from deeprank2_tpu_torch.neuralnets.gnn.foutnet import FoutNet
    from deeprank2_tpu_torch.neuralnets.gnn.ginet import GINet as GINetClustered
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_blocksparse import GINetBlockSparse
    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetClusteredDiag, GINetDense
    from deeprank2_tpu_torch.neuralnets.gnn.sgat import SGAT
    from deeprank2_tpu_torch.neuralnets.gnn.vanilla_gnn import VanillaNetwork, VanillaNetworkBlocked

    std = lambda feats: {f: {"standardize": True} for f in feats}  # noqa: E731
    # the diff features carry the substitution signal the severity target is
    # built from (srv_severity); res_* give the context the reference's SRV
    # configs would also see
    srv_feats = ["diff_charge", "diff_size", "diff_pI", "diff_conservation", "res_charge", "res_size", "res_pI"]
    ppi_feats = ["res_charge", "res_size", "res_mass", "res_pI"]
    atom_feats = ["atom_charge", "res_size", "res_mass"]  # non-constant (a constant feature standardizes to NaN — reference behavior)
    srv_kwargs = {"node_features": srv_feats, "features_transform": std(srv_feats)}
    ppi_kwargs = {"node_features": ppi_feats, "features_transform": std(ppi_feats)}
    atom_kwargs = {"node_features": atom_feats, "features_transform": std(atom_feats)}

    return {
        "vanilla_srv_regress": (VanillaNetwork, "vanilla", "regress", "severity", 4, False, srv_kwargs, False),
        "vanilla_srv_classif": (VanillaNetwork, "vanilla", "classif", "binary", 4, False, srv_kwargs, False),
        "ginet_ppi_classif": (_no_dropout(GINetClustered), "ginet", "classif", "binary", 3, True, ppi_kwargs, False),
        # the dense graph-diagonal fast path (K1/K2)
        "ginet_dense_diag_classif": (_no_dropout(GINetDense), "ginet_nocluster", "classif", "binary", 3, False, ppi_kwargs, False),
        # the no-cluster BCSR fast path (K5) on atomic graphs
        "ginet_bcsr_classif": (_no_dropout(GINetBlockSparse), "ginet_nocluster", "classif", "binary", 3, False, atom_kwargs, False),
        # the blocked-edge fast path (K6f/K6b)
        "vanilla_blocked_classif": (VanillaNetworkBlocked, "vanilla", "classif", "binary", 3, False, atom_kwargs, False),
        # the clustered block-sparse fast path (K5, K3/K4)
        "ginet_clustered_bcsr_classif": (_no_dropout(GINetClusteredBlockSparse), "ginet", "classif", "binary", 3, True, ppi_kwargs, False),
        # the graph-diagonal clustered fast path (K1, K3/K4)
        "ginet_clustered_diag_classif": (_no_dropout(GINetClusteredDiag), "ginet", "classif", "binary", 3, True, ppi_kwargs, False),
        "fout_atom_classif": (FoutNet, "fout", "classif", "binary", 3, True, atom_kwargs, False),
        "sgat_atom_classif": (SGAT, "sgat", "classif", "binary", 3, True, {**atom_kwargs, "edge_features": ["distance"]}, False),
        # raw mapped grids span ~1e6 value ranges (summed Coulomb channels),
        # so early-epoch losses explode to ~1e11 on BOTH sides — GridDataset
        # has no features_transform in the reference either; judge parity by
        # max_loss_delta_rel and the metrics, not the absolute loss delta
        "cnn_grid_classif": (CnnClassification, "cnn", "classif", "binary", 3, False, {}, True),
        # the edge-partitioned GINet (K7 on each rank; run_edgepart_config)
        "ginet_edgepart_ba": (None, "ginet_nocluster", "regress", "dockq", None, False, ppi_kwargs, False),
    }


def run_all(
    data_dir: Path,
    out_dir: Path,
    configs: list[str],
    epochs: int,
    folds: int = 0,
    *,
    store: str = "hdf5",
    device=None,
    ranks: int = 1,
    corpus: dict | None = None,
) -> list[dict]:
    """Run ``configs`` (names of :data:`CONFIG_NAMES`) and return one report
    each. The corpus flavors they need are featurized into ``store``
    (``"hdf5"`` files under ``out_dir/corpus``, or ``"memory"``), unless
    ``corpus`` gives them (``{flavor: path or MemoryStore}``). ``device``
    is the Trainers' (CUDA unless ``"cpu"``), ``ranks`` the edge
    partition's. Every model starts from the Trainer's own seed-7
    initialization and steps with ``ReferenceAdam``."""
    unknown = [c for c in configs if c not in CONFIG_NAMES]
    if unknown:
        msg = f"unknown configs {unknown}; expected names of {CONFIG_NAMES}"
        raise ValueError(msg)
    needed = [f for f in dict.fromkeys(CONFIG_FLAVORS[c] for c in configs) if corpus is None or f not in corpus]
    corpus = {**(corpus or {}), **(featurize_corpus(data_dir, out_dir / "corpus", store, needed) if needed else {})}
    table = config_table()
    reports = []
    for name in configs:
        source = corpus[CONFIG_FLAVORS[name]]
        model_cls, mirror_kind, task, target, batch_size, clustered, ds_kwargs, grid = table[name]
        if name == "ginet_edgepart_ba":
            reports.append(
                run_edgepart_config(source, epochs=epochs, dataset_kwargs=ds_kwargs, device=device, ranks=ranks)
            )
            continue
        reports.append(
            run_trainer_config(
                name, source,
                model_cls=model_cls, mirror_kind=mirror_kind, task=task, target=target,
                epochs=epochs, batch_size=batch_size, clustered=clustered, folds=folds,
                dataset_kwargs=ds_kwargs, grid=grid, device=device,
            )
        )  # fmt: skip
    return reports


def format_table(reports: list[dict]) -> str:
    lines = [
        "| config | n | folds | epochs | max |Δloss| | max rel |Δloss| | synced 1-epoch rel Δ | max |Δval-metric| | metrics (port) | metrics (torch mirror) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in reports:
        fmt = lambda m: ", ".join(f"{k}={v:.4f}" for k, v in m.items())  # noqa: E731
        dv = f"{r['max_val_metric_delta']:.2e}" if "max_val_metric_delta" in r else "-"
        sy = f"{r['synced_epoch_rel_delta']:.2e}" if "synced_epoch_rel_delta" in r else "-"
        lines.append(
            f"| {r['config']} | {r['entries']} | {r.get('folds', '-')} | {r['epochs']} | {r['max_loss_delta']:.2e} "
            f"| {r['max_loss_delta_rel']:.2e} | {sy} | {dv} | {fmt(r['metrics_port'])} | {fmt(r['metrics_mirror'])} |"
        )
    return "\n".join(lines)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data", default="tests/data", help="reference-layout data dir (pdb/, pssm/, ref/)")
    parser.add_argument("--out", default="parity_out", help="work/output dir")
    parser.add_argument("--configs", nargs="*", default=list(CONFIG_NAMES))
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--folds", type=int, default=3, help="k-fold CV (0/1 = single train run)")
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--store", default="hdf5", choices=("hdf5", "memory"), help="featurize into HDF5 files (needs h5py) or into memory")
    parser.add_argument("--ranks", type=int, default=1, help="ranks of the edge partition (ginet_edgepart_ba)")
    args = parser.parse_args()

    out = Path(args.out)
    reports = run_all(Path(args.data), out, args.configs, args.epochs, args.folds, store=args.store, device=args.device, ranks=args.ranks)
    out_json = out / "parity_report.json"
    out_json.write_text(json.dumps(reports, indent=2))
    print(format_table(reports))
    print(f"\nfull report: {out_json}")


if __name__ == "__main__":
    main()
