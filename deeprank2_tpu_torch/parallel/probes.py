"""Rank functions of the parallel paths, for :func:`parallel.launch.run`
(which spawns each rank and imports this module there): the tests hold
their results against the JAX package, ``tools/dryrun_multichip.py`` and
``chip_smoke.py`` against one rank of the same model.

Every function takes ``(rank, world_size, spec)`` and returns host values
(numpy arrays, floats, dicts). ``spec["device"]`` is ``"cuda"`` (the
rank's card, ``cluster.rank_device``; the default, which raises without a
card) or ``"cpu"``; a model comes from
``spec["model"]`` (``"module:Class"`` under ``deeprank2_tpu_torch``) with
the state dict ``spec["state"]`` when given (the reference's parameter
names), and ``spec["dropout_free"]`` sets its dropout to 0. Collective
counts (``parallel/comm.py``) and kernel launches (the ops modules'
counters, by kernel and by form) are read over the step they name.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from deeprank2_tpu_torch.ops import batch as batches
from deeprank2_tpu_torch.ops import block_sparse, diag_spmm, ginet_tower, segment_sorted, slotpool, vanilla
from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
from deeprank2_tpu_torch.ops.optim import Adam
from deeprank2_tpu_torch.parallel import blocksparse_partition as bp
from deeprank2_tpu_torch.parallel import cluster, comm, dp
from deeprank2_tpu_torch.parallel import edge_partition as ep

KERNEL_MODULES = (diag_spmm, slotpool, block_sparse, vanilla, segment_sorted, ginet_tower)


def reset_launches() -> None:
    for m in KERNEL_MODULES:
        m.reset_launches()


def launches() -> dict:
    """The kernels launched since :func:`reset_launches`: counts by kernel,
    and by ``"kernel[form]"`` for the kernels with forms (nonzero only)."""
    by_kernel = {k: n for m in KERNEL_MODULES for k, n in m.launches.items() if n}
    by_form = {f"{k}[{form}]": n for m in KERNEL_MODULES for k, forms in getattr(m, "launches_by_dtype", {}).items() for form, n in forms.items() if n}
    return {"by_kernel": by_kernel, "by_form": by_form}


def device_of(spec: dict) -> torch.device:
    return cluster.rank_device(spec.get("device", "cuda"))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def model_of(spec: dict, dev: torch.device):
    module, name = spec["model"].split(":")
    cls = getattr(importlib.import_module(f"deeprank2_tpu_torch.{module}"), name)
    model = cls(spec["feat"], spec.get("out", 2), spec.get("edge_dim", 1), device=dev, generator=torch.Generator().manual_seed(spec.get("seed", 0)))
    if spec.get("state") is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in spec["state"].items()})
    if spec.get("dropout_free"):
        model.dropout = 0.0
    return model


def host_state(model) -> dict:
    """A copy of the state (on the CPU ``.numpy()`` would alias it)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def host_grads(model) -> dict:
    """Each parameter's gradient (zeros where it took no part)."""
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu().numpy().copy() for k, p in model.named_parameters()}


def classif_loss(model, loss_fn):
    def compute_loss(batch, generator, training):
        pred = model(batch, training=training, generator=generator)
        return loss_fn(pred, batch.y.long(), batch.y_mask), pred

    return compute_loss


def _timed_steps(step, spec: dict, dev: torch.device, out: dict) -> None:
    """``spec["warm"]`` untimed train steps, then ``spec["steps"]`` timed
    ones: each step's loss and predictions, the collectives and kernel
    launches of the first timed step (``comm_train``, ``launches_train``)
    and the timed steps' mean seconds (``step_s``, host clock, the card
    synchronised)."""
    for _ in range(spec.get("warm", 0)):
        step()
    steps = spec.get("steps", 2)
    sync(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        comm.reset_counts()
        reset_launches()
        loss, pred = step()
        if i == 0:
            out["comm_train"], out["launches_train"] = comm.snapshot(), launches()
        out["losses"].append(float(loss))
        out["preds"].append(pred.detach().cpu().numpy())
    sync(dev)
    out["step_s"] = (time.perf_counter() - t0) / max(steps, 1)


def dp_steps(rank: int, world: int, spec: dict) -> dict:
    """Data-parallel train steps (CrossEntropy, Adam lr ``spec["lr"]``,
    weight decay ``spec["wd"]``; see :func:`_timed_steps`) and one eval step
    on this rank's shard of ``getattr(ops.batch, spec["collate"])(
    spec["entries"], world, spec["per_shard"], **spec["collate_kwargs"])``:
    each step's pmean'ed loss and gathered predictions, the eval step's,
    the final parameters, the collectives and kernel launches of the first
    timed train step and of the eval step. With ``spec["one_rank"]`` (the
    single-device collate's name) the eval predictions of each shard are
    held against the same model on one rank, the shard's graphs collated
    alone (``max_err``)."""
    dev = device_of(spec)
    model = model_of(spec, dev)
    opt = Adam(model.parameters(), lr=spec.get("lr", 1e-3), weight_decay=spec.get("wd", 1e-5))
    compute_loss = classif_loss(model, CrossEntropyLoss())
    train, evaluate = dp.make_dp_train_step(compute_loss, opt), dp.make_dp_eval_step(compute_loss)
    kwargs = spec.get("collate_kwargs", {})
    shards, names = getattr(batches, spec["collate"])(spec["entries"], world, spec["per_shard"], device="cpu", **kwargs)
    batch = shards[rank].to(dev)
    base = torch.Generator().manual_seed(spec.get("seed", 0))
    out = {"names": names, "losses": [], "preds": []}
    _timed_steps(lambda: train(batch, base), spec, dev, out)
    comm.reset_counts()
    reset_launches()
    loss, pred = evaluate(batch)
    out["comm_eval"], out["launches_eval"] = comm.snapshot(), launches()
    out["eval_loss"], out["eval_pred"] = float(loss), pred.cpu().numpy()
    out["params"] = host_state(model)
    if spec.get("one_rank"):
        per = spec["per_shard"]
        by_name = {e["entry_name"]: e for e in spec["entries"]}
        err = 0.0
        with torch.no_grad():
            for s in range(world):
                shard = [nm for nm in names[s * per : (s + 1) * per] if nm]
                if shard:
                    solo, _ = getattr(batches, spec["one_rank"])([by_name[nm] for nm in shard], pad_graphs=per, device=dev, **kwargs)
                    want = model(solo).cpu().numpy()
                    err = max(err, float(np.abs(out["eval_pred"][s, : len(shard)] - want[: len(shard)]).max()))
        out["max_err"] = err
    return out


def _gp_batch(spec: dict, world: int, dev: torch.device):
    """This rank's part of ``spec["entries"]`` in ``spec["form"]``
    (``partitioned`` or ``ring``), and the whole batch (for one rank)."""
    whole, _ = batches.collate_graphs_blocksparse(spec["entries"], pad_graphs=spec.get("pad_graphs"), device="cpu")
    whole = whole.to(dev)
    parts = (bp.partition_blocksparse_batch_ring if spec["form"] == "ring" else bp.partition_blocksparse_batch)(whole, world)
    return parts, whole


def gp_forward(rank: int, world: int, spec: dict) -> dict:
    """The block-sparse graph-parallel forward of ``GINetBlockSparse``'s
    parameters on this rank's part (``spec["form"]``: ``partitioned``, the
    all-gather, or ``ring``), its gradients of ``sum(out[:n] ** 2)``
    (``n = spec["graphs"]``) pmean'ed over the ranks, the same on one rank
    (the whole batch, this process), the collectives and launches of the
    forward and of the backward."""
    dev = device_of(spec)
    model = model_of(spec, dev)
    parts, whole = _gp_batch(spec, world, dev)
    part = parts[rank]
    forward = (bp.make_blocksparse_ginet_ring_forward if spec["form"] == "ring" else bp.make_blocksparse_ginet_forward)(model)
    n = spec["graphs"]
    comm.reset_counts()
    reset_launches()
    out = forward(part)
    fwd = {"comm": comm.snapshot(), "launches": launches()}
    comm.reset_counts()
    reset_launches()
    (out[:n] ** 2).sum().backward()
    dp.sync_gradients(list(model.parameters()), out.sum())
    bwd = {"comm": comm.snapshot(), "launches": launches()}
    grads = host_grads(model)
    model.zero_grad(set_to_none=True)
    ref = model(whole)
    (ref[:n] ** 2).sum().backward()
    ref_grads = host_grads(model)
    return {
        "out": out.detach().cpu().numpy(),
        "grads": grads,
        "one_rank_out": ref.detach().cpu().numpy(),
        "one_rank_grads": ref_grads,
        "forward": fwd,
        "backward": bwd,
    }


def spmm_vjp(rank: int, world: int, spec: dict) -> dict:
    """The VJPs of :func:`bcsr_spmm_sharded` and :func:`ring_bcsr_spmm`
    alone: ``x`` and ``w`` ``[V, F]`` from ``spec["seed"]``; the gradient of
    ``sum(spmm(x_local) * w_local)`` w.r.t. ``x_local``, gathered, and
    ``A @ w`` on one rank (by symmetry the two are equal)."""
    dev = device_of(spec)
    parts, whole = _gp_batch({**spec, "form": "partitioned"}, world, dev)
    ring = bp.partition_blocksparse_batch_ring(whole, world)[rank]
    st = parts[0].structure
    rng = np.random.default_rng(spec.get("seed", 5))
    x = torch.from_numpy(rng.normal(size=(st.padded_nodes, spec.get("width", 4))).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(st.padded_nodes, spec.get("width", 4))).astype(np.float32))
    rows = st.padded_rows
    mine = slice(rank * rows, (rank + 1) * rows)
    result = {}
    for name, spmm in (
        ("sharded", lambda xl: bp.bcsr_spmm_sharded(parts[rank].structure, xl)),
        ("ring", lambda xl: bp.ring_bcsr_spmm(ring.diag, ring.off, ring.off_has_blocks, xl)),
    ):
        xl = x[mine].to(dev).requires_grad_()
        (spmm(xl) * w[mine].to(dev)).sum().backward()
        result[name] = comm.all_gather_rows(xl.grad).cpu().numpy()
    full = whole.structure
    result["one_rank"] = block_sparse.bcsr_spmm_kernel(full, w[: full.padded_nodes].T.contiguous().to(dev)).T.cpu().numpy()
    return result


def edge_forward(rank: int, world: int, spec: dict) -> dict:
    """The edge-partitioned (``spec["form"]``: ``all-gather`` or ``ring``)
    forward of the no-cluster GINet on this rank's part of
    ``collate_graphs(spec["entries"])``, its gradients of ``sum(out ** 2)``
    pmean'ed, the same on one rank, and the forward's collectives."""
    dev = device_of(spec)
    model = model_of(spec, dev)
    whole, _ = batches.collate_graphs(spec["entries"], pad_graphs=spec.get("pad_graphs"), device="cpu")
    ring = spec["form"] == "ring"
    part = (ep.partition_graph_batch_ring if ring else ep.partition_graph_batch)(whole.to(dev), world)[rank]
    forward = (ep.make_ring_ginet_forward if ring else ep.make_edge_partitioned_ginet_forward)(model)
    comm.reset_counts()
    reset_launches()
    out = forward(part)
    fwd = {"comm": comm.snapshot(), "launches": launches()}
    (out**2).sum().backward()
    dp.sync_gradients(list(model.parameters()), out.sum())
    grads = host_grads(model)
    model.zero_grad(set_to_none=True)
    ref = model(whole.to(dev))
    (ref**2).sum().backward()
    return {
        "out": out.detach().cpu().numpy(),
        "grads": grads,
        "one_rank_out": ref.detach().cpu().numpy(),
        "one_rank_grads": host_grads(model),
        "forward": fwd,
    }


def mesh_groups(rank: int, world: int, spec: dict) -> dict:  # noqa: ARG001
    """``cluster.hybrid_mesh`` with its defaults and with ``dp = world``:
    each mesh's fields and a psum of ``rank + 1`` over each of its groups;
    and the ``ValueError`` of a mesh that does not cover the world."""
    out = {}
    for name, kw in (("default", {}), ("dp", {"dp": world})):
        mesh = cluster.hybrid_mesh(**kw)
        one = torch.tensor([float(rank + 1)])
        out[name] = {
            "dp": mesh.dp,
            "gp": mesh.gp,
            "dp_rank": mesh.dp_rank,
            "gp_rank": mesh.gp_rank,
            "dp_sum": float(comm.psum(one, mesh.dp_group)) if mesh.dp > 1 else None,
            "gp_sum": float(comm.psum(one, mesh.gp_group)) if mesh.gp > 1 else None,
        }
    try:
        cluster.hybrid_mesh(dp=world, gp=2)
    except ValueError as e:
        out["error"] = str(e)
    return out


def edge_scaling(rank: int, world: int, spec: dict) -> dict:  # noqa: ARG001
    """``edge_partition.edge_partition_scaling_report`` at this world size."""
    return ep.edge_partition_scaling_report(device=device_of(spec))


def comm_shapes(rank: int, world: int, spec: dict) -> dict:
    """The three ``comm_shape`` reports at this world size."""
    from deeprank2_tpu_torch.parallel import comm_shape

    dev = device_of(spec)
    return {
        "dp": comm_shape.dp_train_report(device=dev),
        "edge": comm_shape.edge_partition_report(device=dev),
        "ring": comm_shape.edge_partition_report(ring=True, device=dev),
        "blocksparse_ring": comm_shape.blocksparse_ring_report(device=dev),
    }


def in_memory_dataset(entries, train_source=None, clustering_method=None, node_features=("x",), edge_features=("edge_attr",)):
    """A ``GraphDataset`` over ``entries`` held in memory (for machines
    without h5py): its constructor sets what the file checks would (binary
    classification target, the features named, the clustering method
    named) and ``load_one_graph`` returns the entry itself, its cluster ids
    included."""
    from deeprank2_tpu_torch.dataset import GraphDataset

    class InMemoryGraphDataset(GraphDataset):
        def __init__(self):  # noqa: PLW0231 — the file checks of the parent are what this replaces
            self.hdf5_paths, self.subset, self.train_source = ["in-memory"], None, train_source
            self.target, self.target_transform, self.target_filter = "binary", False, None
            self.root, self.use_tqdm = "./", False
            self._check_task_and_classes("classif", None)
            self._entries = {e["entry_name"]: e for e in entries}
            self.index_entries = [("in-memory", e["entry_name"]) for e in entries]
            self.df = self.means = self.devs = self.train_means = self.train_devs = None
            self._cache, self._cache_capacity = {}, 16384
            self.node_features, self.edge_features = list(node_features), list(edge_features)
            self.clustering_method, self.features_transform, self.inherited_params = clustering_method, None, None

        def load_one_graph(self, fname, entry_name):  # noqa: ARG002
            return self._entries[entry_name]

    return InMemoryGraphDataset()


class PassLosses:
    """An output exporter that keeps each pass's loss."""

    def __init__(self):
        self.losses = []

    def __enter__(self):
        return self

    def __exit__(self, *exc_info) -> None:
        pass

    def is_compatible_with(self, output_data_shape, target_data_shape=None) -> bool:  # noqa: ARG002
        return True

    def process(self, pass_name, epoch_number, entry_names, output_values, target_values, loss) -> None:  # noqa: ARG002
        self.losses.append((pass_name, epoch_number, loss, len(entry_names)))


def _minus(after: dict, before: dict) -> dict:
    """Counters ``after - before``, nested dicts of ints, zeros dropped."""
    out = {}
    for k, v in after.items():
        d = _minus(v, before.get(k, {})) if isinstance(v, dict) else v - before.get(k, 0)
        if d:
            out[k] = d
    return out


def _one_rank_check(spec: dict, dev: torch.device, initial: dict, first: dict) -> dict:
    """The first train step held against ``spec["one_rank"]["model"]`` with
    the run's initial parameters on one rank: that batch's graphs (the names
    the loader gave it, in their order) collated whole by
    ``ops.batch.<spec["one_rank"]["collate"]>``, its logits (``max_err``)
    and the gradients of its CrossEntropy loss (``grad_err``, and
    ``grad_max``, the largest gradient)."""
    ref = spec["one_rank"]
    e0 = spec["entries"][0]
    edge_dim = e0["edge_attr"].shape[1] if e0["edge_attr"].ndim == 2 else 1
    model = model_of({"model": ref["model"], "feat": e0["x"].shape[1], "edge_dim": edge_dim, "state": initial, "dropout_free": True}, dev)
    by_name = {e["entry_name"]: e for e in spec["entries"]}
    names = first["names"]
    rows = [i for i, nm in enumerate(names) if nm]
    whole, _ = getattr(batches, ref["collate"])([by_name[names[i]] for i in rows], device=dev, **ref.get("kwargs", {}))
    pred = model(whole)
    CrossEntropyLoss()(pred, whole.y.long(), whole.y_mask).backward()
    want = host_grads(model)
    got = first["pred"][rows]
    return {
        "max_err": float(np.abs(got - pred.detach().cpu().numpy()[: len(rows)]).max()),
        "grad_err": max(float(np.abs(first["grads"][k] - w).max()) for k, w in want.items()),
        "grad_max": max(float(np.abs(w).max()) for w in want.values()),
        "graphs": len(rows),
    }


def trainer_run(rank: int, world: int, spec: dict) -> dict:
    """``Trainer.train`` of ``spec["model"]`` on this rank: with
    ``data_parallel=spec["dp"]`` (a ``graph_parallel`` model splits its
    batches either way), on ``GraphDataset(spec["hdf5"], ...)`` or, from
    ``spec["entries"]``, on :func:`in_memory_dataset`; the JAX Trainer's
    initial parameters ``spec["state"]`` when given. Returns the passes'
    losses as rank 0's exporter saw them (none on the other ranks), the
    final parameters, the buckets, the passes' host timings, the kernels
    launched and the collectives over the run, each train step's seconds
    (``step_s``: the card synchronised before and after it, so the loader
    no longer runs ahead of a step), and the first train step's kernel
    launches and collectives. With ``spec["one_rank"]`` the first train
    step is held against one rank (:func:`_one_rank_check`)."""
    from deeprank2_tpu_torch.dataset import GraphDataset
    from deeprank2_tpu_torch.trainer import Trainer

    module, name = spec["model"].split(":")
    cls = getattr(importlib.import_module(f"deeprank2_tpu_torch.{module}"), name)
    if spec.get("dropout_free"):
        cls = type(cls.__name__, (cls,), {"dropout": 0.0})
    method = spec.get("clustering_method")
    if "hdf5" in spec:
        train = GraphDataset(hdf5_path=spec["hdf5"], target=spec.get("target", "binary"), clustering_method=method)
        val = GraphDataset(hdf5_path=spec["hdf5"], train_source=train, clustering_method=method) if method else None
    else:
        train = in_memory_dataset(spec["entries"], clustering_method=method)
        val = in_memory_dataset(spec["entries"][:1], train_source=train, clustering_method=method) if method else None
    recorder = PassLosses()
    probe = {"step_s": [], "names": None, "first": None}  # names: of the batch the loader gave last

    class ProbedTrainer(Trainer):
        """The Trainer with its first train step (its batch's names among
        them) and each train step's time kept; in memory, no HDF5 file takes
        the clusters: the entries carry their generator's cluster ids."""

        def _iter_batches(self, *args, **kwargs):
            for batch, names, stats in super()._iter_batches(*args, **kwargs):
                probe["names"] = names
                yield batch, names, stats

        def _build_step_functions(self) -> None:
            super()._build_step_functions()
            step = self._train_step

            def timed(batch):
                sync(self.device)
                before = (comm.snapshot(), launches())
                t0 = time.perf_counter()
                loss, pred = step(batch)
                sync(self.device)
                probe["step_s"].append(time.perf_counter() - t0)
                if probe["first"] is None:
                    probe["first"] = {
                        "names": probe["names"],
                        "pred": pred.float().cpu().numpy(),
                        "grads": host_grads(self.model),
                        "comm": _minus(comm.snapshot(), before[0]),
                        "launches": _minus(launches(), before[1]),
                    }
                return loss, pred

            self._train_step = timed

        def _write_clusters(self, dataset) -> None:
            if "hdf5" in spec:
                super()._write_clusters(dataset)
                return
            missing = [name for (_, name), i in zip(dataset.index_entries, range(len(dataset))) if dataset.get(i).get("cluster0") is None]
            if missing:
                msg = f"entries without cluster ids: {missing}"
                raise ValueError(msg)

    trainer = ProbedTrainer(cls, dataset_train=train, dataset_val=val, output_exporters=[recorder], seed=spec.get("seed", 42), data_parallel=spec.get("dp", False), device=spec.get("device"))
    if spec.get("state") is not None:
        trainer.model.load_state_dict({k: torch.as_tensor(v) for k, v in spec["state"].items()})
        trainer.configure_optimizers()
    initial = host_state(trainer.model)
    reset_launches()
    comm.reset_counts()
    trainer.train(nepoch=spec.get("nepoch", 2), batch_size=spec["batch_size"], shuffle=spec.get("shuffle", True), filename=spec.get("filename"), best_model=spec.get("best_model", True))
    out = {
        "losses": recorder.losses,
        "params": host_state(trainer.model),
        "epoch_saved_model": trainer.epoch_saved_model,
        "bs_caps": getattr(trainer, "_bs_caps", None),
        "pass_stats": [{k: v for k, v in p.items() if k in ("pass", "epoch", "seconds", "loop_s", "batches", "collate_s")} for p in trainer.pass_stats],
        "launches": launches(),
        "comm": comm.snapshot(),
        "device": str(trainer.device),
        "step_s": probe["step_s"],
        "first_step": {k: probe["first"][k] for k in ("comm", "launches")},
    }
    if spec.get("one_rank"):
        out["one_rank"] = _one_rank_check(spec, trainer.device, initial, probe["first"])
    return out


def _clustered_copies(entries: list[dict], members: int) -> list[dict]:
    """``entries`` with depth-0 clusters of ``members`` consecutive nodes and
    depth-1 clusters of three depth-0 ones (the JAX dry run's)."""
    out = []
    for e in entries:
        c0 = np.arange(e["x"].shape[0]) // members
        out.append({**e, "cluster0": c0.astype(np.int32), "cluster1": (np.arange(int(c0.max()) + 1) // 3).astype(np.int32)})
    return out


def dryrun_paths(rank: int, world: int, spec: dict) -> dict:
    """Every parallel path once, as the JAX package's ``dryrun_multichip``
    runs them (its sizes: ``spec["per_shard"]`` graphs of ``spec["nodes"]``
    nodes a rank, F = 38): one data-parallel train step and the eval step of
    the COO GINet, GINetDense, VanillaNetworkBlocked,
    GINetClusteredBlockSparse (slot8), GINetClusteredDiag and the mixed
    region layout, each shard's predictions against the same model on one
    rank (``max_err``); the edge-partitioned and ring forwards, and the
    block-sparse partitioned and ring forwards, against one rank; then the
    ``comm_shape`` reports. Returns ``{path: {"loss", "max_err",
    "launches"}}`` and ``"comm"``."""
    from deeprank2_tpu_torch.ops.synthetic import synthetic_entries

    dev = device_of(spec)
    feat, edge_dim, per, nodes = 38, 6, spec.get("per_shard", 2), spec.get("nodes", 24)
    n = per * world
    cb_entries = _clustered_copies(synthetic_entries(n, nodes, feat, edge_dim, seed=8), 4)
    dp_paths = {
        "dp": ("neuralnets.gnn.ginet:GINet", "collate_graphs", "collate_graphs_sharded", synthetic_entries(n, nodes, feat, edge_dim), {}),
        "dense_dp": ("neuralnets.gnn.ginet_dense:GINetDense", "collate_graphs_dense", "collate_graphs_dense_sharded", synthetic_entries(n, nodes, feat, edge_dim), {}),
        "blocked_edge_dp": ("neuralnets.gnn.vanilla_gnn:VanillaNetworkBlocked", "collate_graphs_blocked", "collate_graphs_blocked_sharded", synthetic_entries(n, nodes, feat, edge_dim), {}),
        "clustered_bs_dp": ("neuralnets.gnn.clustered_blocksparse:GINetClusteredBlockSparse", "collate_graphs_blocksparse_clustered", "collate_graphs_blocksparse_clustered_sharded", cb_entries, {"slot8": True}),
        "diag_clustered_dp": ("neuralnets.gnn.ginet_dense:GINetClusteredDiag", "collate_graphs_diag_clustered", "collate_graphs_diag_clustered_sharded", cb_entries, {}),
        "mixed_region_dp": ("neuralnets.gnn.ginet_dense:GINetClusteredDiag", "collate_graphs_diag_clustered", "collate_graphs_diag_clustered_sharded", _clustered_copies(synthetic_entries(n, nodes, feat, edge_dim, seed=13), 2), {}),
    }
    out = {}
    for name, (model_name, solo_collate, collate, entries, kwargs) in dp_paths.items():
        spec_p = {"model": model_name, "feat": feat, "edge_dim": edge_dim, "device": spec.get("device", "cuda"), "entries": entries, "collate": collate, "per_shard": per, "collate_kwargs": kwargs, "steps": 1, "one_rank": solo_collate}
        res = dp_steps(rank, world, spec_p)
        out[name] = {"loss": res["losses"][0], "max_err": res["max_err"], "launches": res["launches_train"], "comm": res["comm_train"]}
    edge_entries = synthetic_entries(n, nodes, feat, edge_dim)
    for name, form in (("edge_partition", "all-gather"), ("ring_halo", "ring")):
        res = edge_forward(rank, world, {"model": "neuralnets.gnn.ginet_nocluster:GINet", "feat": feat, "edge_dim": edge_dim, "device": spec.get("device", "cuda"), "entries": edge_entries, "pad_graphs": n, "form": form, "seed": 2})
        out[name] = {"max_err": float(np.abs(res["out"] - res["one_rank_out"]).max()), "launches": res["forward"]["launches"], "comm": res["forward"]["comm"]}
    bs_entries = synthetic_entries(2, 40, feat, edge_dim, seed=5)
    for name, form in (("blocksparse_partition", "partitioned"), ("blocksparse_ring", "ring")):
        res = gp_forward(rank, world, {"model": "neuralnets.gnn.ginet_blocksparse:GINetBlockSparse", "feat": feat, "edge_dim": edge_dim, "device": spec.get("device", "cuda"), "entries": bs_entries, "form": form, "graphs": 2, "seed": 5})
        out[name] = {"max_err": float(np.abs(res["out"][:2] - res["one_rank_out"][:2]).max()), "launches": res["forward"]["launches"], "comm": res["forward"]["comm"]}
    out["comm"] = comm_shapes(rank, world, spec)
    return out


def run_cases(rank: int, world: int, cases: list[tuple[str, str, dict]]) -> dict:
    """Several rank functions of this module in one spawn: ``cases`` are
    ``(name, function name, spec)``; returns ``{name: result}``."""
    return {name: globals()[fn](rank, world, spec) for name, fn, spec in cases}
