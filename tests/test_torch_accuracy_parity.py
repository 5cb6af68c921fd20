"""The accuracy-parity twin (deeprank2_tpu_torch/tools/accuracy_parity.py)
against the JAX harness (deeprank2_tpu/tools/accuracy_parity.py): the
metric helpers on seeded scores with ties, the corpus assembly (query ids,
chains, targets, the generated decoy PDBs byte for byte), the mirror's
batches, the readout of the port's exported probabilities, and
``ReferenceAdam`` against ``torch.optim.Adam`` bit for bit."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from deeprank2_tpu.tools import accuracy_parity as jap
from deeprank2_tpu_torch.ops import optim
from deeprank2_tpu_torch.tools import accuracy_parity as pap


def _scores(seed: int, n: int = 48):
    """Labels, tied scores (six levels), and logits with tied rows."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    scores = rng.integers(0, 6, n) / 5.0
    logits = rng.normal(size=(n, 2)).astype(np.float32)
    logits[::4] = logits[1::4]
    return labels, scores, logits


@pytest.mark.parametrize("seed", range(4))
def test_metric_helpers_equal_jax(seed) -> None:
    labels, scores, logits = _scores(seed)
    assert pap.binary_auc(scores, labels) == jap.binary_auc(scores, labels)
    assert np.isnan(pap.binary_auc(scores, np.zeros_like(labels))) and np.isnan(jap.binary_auc(scores, np.zeros_like(labels)))
    pred = (scores > 0.5).astype(np.int64)
    assert pap.binary_mcc(pred, labels) == jap.binary_mcc(pred, labels)
    assert pap.binary_mcc(np.ones_like(labels), labels) == jap.binary_mcc(np.ones_like(labels), labels) == 0.0
    probs = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    np.testing.assert_equal(pap.classif_metrics(probs, labels), jap.classif_metrics(probs, labels))
    np.testing.assert_equal(pap.regress_metrics(logits[:, 0], scores), jap.regress_metrics(logits[:, 0], scores))
    np.testing.assert_equal(pap.regress_metrics(np.ones(len(scores)), scores), jap.regress_metrics(np.ones(len(scores)), scores))
    for task, out in (("classif", logits), ("regress", logits[:, :1])):
        np.testing.assert_equal(pap._outputs_to_metrics(task, out, labels), jap._outputs_to_metrics(task, out, labels))


def test_exported_readout_is_the_trainers() -> None:
    """``_as_exported`` is the log of the Trainer's own export
    (``Trainer._export_outputs``: a float32 softmax a graph), so a
    saturated row ties at probability 1.0 on both sides."""
    from deeprank2_tpu_torch.trainer import Trainer

    _, _, logits = _scores(0, 12)
    logits[0] = (40.0, -3.0)
    logits[1] = (-2.0, 35.0)
    logits[2] = (1.0, 30.0)
    trainer = Trainer.__new__(Trainer)
    trainer.task = "classif"
    names = [f"g{i}" for i in range(len(logits))]
    exported, _, _ = trainer._export_outputs(logits, np.zeros(len(logits)), np.ones(len(logits), bool), names)
    np.testing.assert_array_equal(pap._as_exported(logits), np.log(np.array([np.atleast_1d(o) for o in exported])))
    assert np.exp(pap._as_exported(logits))[1, 1] == np.exp(pap._as_exported(logits))[2, 1] == 1.0


def test_ppi_assembly_equals_jax(data_path, tmp_path) -> None:
    """The PPI queries (residue resolution; the atom flavor differs only in
    the resolution string) and the generated decoys, byte for byte."""
    jq = jap.assemble_ppi_queries(data_path, "residue", tmp_path / "jax", decoys_per_complex=25)
    pq = pap.assemble_ppi_queries(data_path, "residue", tmp_path / "port", decoys_per_complex=25)
    assert len(pq) == len(jq) > 50

    def rel(path: str) -> str:
        p = Path(path)
        for root in (tmp_path / "jax", tmp_path / "port"):
            if p.is_relative_to(root):
                return str(p.relative_to(root))
        return str(p)

    for a, b in zip(pq, jq):
        assert (a.get_query_id(), a.chain_ids, a.resolution, rel(a.pdb_path)) == (b.get_query_id(), b.chain_ids, b.resolution, rel(b.pdb_path))
        assert a.targets == b.targets
    jax_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.pdb"))
    port_files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.pdb"))
    assert port_files == jax_files and len(port_files) == 50
    for f in port_files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_srv_assembly_equals_jax(data_path) -> None:
    jq = jap.assemble_srv_queries(data_path)
    pq = pap.assemble_srv_queries(data_path)
    assert len(pq) == len(jq) > 150
    for a, b in zip(pq, jq):
        assert (a.get_query_id(), a.chain_ids, a.pdb_path, a.pssm_paths, a.variant_residue_number, a.insertion_code) == (
            b.get_query_id(),
            b.chain_ids,
            b.pdb_path,
            b.pssm_paths,
            b.variant_residue_number,
            b.insertion_code,
        )
        assert (a.wildtype_amino_acid.name, a.variant_amino_acid.name) == (b.wildtype_amino_acid.name, b.variant_amino_acid.name)
        assert a.targets == b.targets
    assert {q.targets["binary"] for q in pq} == {0, 1}


@pytest.mark.parametrize("clustered", [False, True])
def test_mirror_batches_equal_jax(clustered) -> None:
    """``_make_chunks`` (the reference-layout batches the mirror trains on)
    array for array, clusters and the coalesced pooled edges included."""
    from deeprank2_tpu_torch.ops.synthetic import ppi_clustered_entries

    entries = ppi_clustered_entries(7, 24, 5, seed=3)
    for e in entries:
        e["edge_attr"] = np.random.default_rng(1).normal(size=(len(e["edge_index"]), 2)).astype(np.float32)
    got = pap._make_chunks(entries, 3, False, clustered)
    want = jap._make_chunks(entries, 3, False, clustered)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_reference_adam_is_torch_adam_bit_for_bit() -> None:
    """Five steps with weight decay on seeded gradients: the parameters
    equal ``torch.optim.Adam``'s bit for bit; the port's JAX-rule ``Adam``
    is not (its bias corrections are rounded to float32)."""
    rng = np.random.default_rng(0)
    init = [torch.tensor(rng.normal(size=s).astype(np.float32)) for s in ((7, 5), (5,), (3, 3))]
    grads = [[torch.tensor(rng.normal(size=p.shape).astype(np.float32)) * 10.0 ** rng.integers(-9, 2) for p in init] for _ in range(5)]

    def run(cls):
        params = [p.clone().requires_grad_(True) for p in init]
        opt = cls(params, lr=1e-3, weight_decay=1e-5)
        for step in grads:
            for p, g in zip(params, step):
                p.grad = g.clone()
            opt.step()
        return [p.detach() for p in params]

    want = run(torch.optim.Adam)
    for got, w in zip(run(optim.ReferenceAdam), want):
        assert torch.equal(got, w)
    assert not all(torch.equal(g, w) for g, w in zip(run(optim.Adam), want))


def test_unknown_store_and_config_raise(tmp_path) -> None:
    with pytest.raises(ValueError, match="store"):
        pap.featurize_corpus(tmp_path, tmp_path / "corpus", "sqlite", [])
    with pytest.raises(ValueError, match="store"):
        pap.featurize_queries([], "ppi_residue", tmp_path / "corpus", "sqlite")
    with pytest.raises(ValueError, match="unknown configs"):
        pap.run_all(tmp_path, tmp_path, ["ginet_ppi_classification"], 1, device="cpu")
    assert set(pap.CONFIG_NAMES) == set(jap.CONFIG_NAMES) == set(pap.config_table()) == set(pap.CONFIG_FLAVORS)
