"""Query pipeline: define data points, build featured graphs, write HDF5.

API-compatible with the reference (deeprank2/query.py): ``Query`` subclasses
``SingleResidueVariantQuery`` / ``ProteinProteinInterfaceQuery`` build graphs
from PDB files, and ``QueryCollection.process`` fans featurization out over a
host-side process pool with one HDF5 writer per worker process
(single-writer-per-file discipline, reference query.py:448-451).

The port's copy of ``deeprank2_tpu/query.py``: the same queries write the
same HDF5. The host count follows ``torch.distributed`` and the start method
follows CUDA's state instead of JAX's; ``h5py`` loads inside ``process``, so
``Query.build`` runs on a machine without it, and
``QueryCollection.process_in_memory`` writes the same layout into a
``utils/store.py:MemoryStore`` there.
"""

from __future__ import annotations

import importlib
import logging
import multiprocessing
import os
import pickle
import pkgutil
import re
import warnings
import random
from dataclasses import MISSING, dataclass, field, fields
from glob import glob
from types import ModuleType
from typing import Literal

import numpy as np

import deeprank2_tpu_torch.features
from deeprank2_tpu_torch.features import components, conservation, contact  # noqa: F401 (defaults)
from deeprank2_tpu_torch.molstruct.aminoacid import AminoAcid, convert_aa_nomenclature
from deeprank2_tpu_torch.molstruct.structure import SingleResidueVariant, StructureArrays
from deeprank2_tpu_torch.ops import _build
from deeprank2_tpu_torch.utils.buildgraph import get_contact_atoms, get_structure, get_surrounding_residues
from deeprank2_tpu_torch.utils.graph import Graph
from deeprank2_tpu_torch.utils.grid import Augmentation, GridSettings, MapMethod, random_rotation_axis_angle
from deeprank2_tpu_torch.utils.parsing.pssm import parse_pssm
from deeprank2_tpu_torch.utils.store import MemoryStore

_log = logging.getLogger(__name__)

# node granularity -> default influence radius / max edge length (Å)
# (reference defaults, query.py:62-67)
RESOLUTION_DEFAULTS = {"residue": 10.0, "atom": 4.5}
VALID_RESOLUTIONS = list(RESOLUTION_DEFAULTS)


@dataclass(repr=False, kw_only=True)
class Query:
    """One data point to featurize; base of the SRV and PPI query flavors.

    Args:
        pdb_path: path to the PDB file to query.
        resolution: "residue" or "atom" node granularity.
        chain_ids: chain identifier(s).
        pssm_paths: chain id -> pssm file path.
        targets: target name -> value.
        influence_radius: inclusion radius in Å (defaults: residue 10, atom 4.5).
        max_edge_length: max edge distance in Å (defaults: residue 10, atom 4.5).
        suppress_pssm_errors: warn instead of raising on pssm/pdb mismatches.
    """

    pdb_path: str
    resolution: Literal["residue", "atom"]
    chain_ids: list[str] | str
    pssm_paths: dict[str, str] = field(default_factory=dict)
    targets: dict[str, float] = field(default_factory=dict)
    influence_radius: float | None = None
    max_edge_length: float | None = None
    suppress_pssm_errors: bool = False

    def __post_init__(self):
        self._model_id = os.path.splitext(os.path.basename(self.pdb_path))[0]
        self.variant = None  # set by SRV subclass

        default_radius = RESOLUTION_DEFAULTS.get(self.resolution)
        if default_radius is None:
            msg = f"resolution must be one of {VALID_RESOLUTIONS}, not {self.resolution!r}"
            raise ValueError(msg)
        self.max_edge_length = self.max_edge_length or default_radius
        self.influence_radius = self.influence_radius or default_radius

        if not isinstance(self.chain_ids, list):
            self.chain_ids = [self.chain_ids]

        # a None for a factory-defaulted field means "use the default"
        for spec in fields(self):
            if getattr(self, spec.name) is None and spec.default_factory is not MISSING:
                setattr(self, spec.name, spec.default_factory())

    # ------------------------------------------------------------------
    def _load_structure(self) -> StructureArrays:
        arrays = get_structure(self.pdb_path, self.model_id)
        if self._pssm_required:
            self._load_pssm_data(arrays)
        return arrays

    def _load_pssm_data(self, arrays: StructureArrays) -> None:
        self._check_pssm()
        for chain_id in arrays.chain_ids:
            if chain_id in self.pssm_paths:
                with open(self.pssm_paths[chain_id], encoding="utf-8") as f:
                    arrays.pssms[chain_id] = parse_pssm(f)

    def _check_pssm(self, verbosity: Literal[0, 1, 2] = 0) -> None:
        """Check that pssm rows match the pdb sequence (reference: query.py:107-162)."""
        if not self.pssm_paths:
            msg = "No pssm paths provided for conservation feature module."
            raise ValueError(msg)

        pssm_file_residues = {}
        for chain, pssm_path in self.pssm_paths.items():
            with open(pssm_path, encoding="utf-8") as fh:
                next(fh)  # header row
                for row in fh:
                    cells = row.split()
                    if cells:
                        pssm_file_residues[chain + cells[0].zfill(4)] = convert_aa_nomenclature(cells[1], 3)

        from deeprank2_tpu_torch.io.pdb import parse_pdb
        from deeprank2_tpu_torch.molstruct.aminoacid import AA_THREE_LETTER

        arrays = parse_pdb(self.pdb_path)
        pdb_file_residues = {}
        for r in range(arrays.num_residues):
            chain_id = arrays.chain_ids[arrays.res_chain[r]]
            if chain_id not in self.pssm_paths:
                continue
            aa_id = int(arrays.res_aa_ids[r])
            if aa_id < 0:
                continue
            icode = arrays.res_icodes[r] or ""
            pdb_file_residues[chain_id + f"{arrays.res_numbers[r]}{icode}".zfill(4)] = AA_THREE_LETTER[aa_id]

        mismatches = []
        missing_entries = []
        for residue, code in pdb_file_residues.items():
            if residue not in pssm_file_residues:
                missing_entries.append(residue)
            elif pssm_file_residues[residue] != code:
                mismatches.append(residue)

        if mismatches or missing_entries:
            error_message = f"Amino acids in PSSM files do not match pdb file for {os.path.split(self.pdb_path)[1]}."
            if verbosity:
                if mismatches:
                    error_message += f"\n\t{len(mismatches)} entries are incorrect."
                    if verbosity == 2:  # noqa: PLR2004
                        error_message += f":\n\t{mismatches}"
                if missing_entries:
                    error_message += f"\n\t{len(missing_entries)} entries are missing."
                    if verbosity == 2:  # noqa: PLR2004
                        error_message += f":\n\t{missing_entries}"
            if not self.suppress_pssm_errors:
                raise ValueError(error_message)
            warnings.warn(error_message)
            _log.warning(error_message)

    @property
    def model_id(self) -> str:
        """Model name (the PDB file's stem unless overridden)."""
        return self._model_id

    @model_id.setter
    def model_id(self, value: str) -> None:
        self._model_id = value

    def __repr__(self) -> str:
        return f"{type(self)}({self.get_query_id()})"

    def build(self, feature_modules: list[str | ModuleType] | str | ModuleType) -> Graph:
        """Build the featured graph from the PDB structure.

        Args:
            feature_modules: modules (or names inside ``deeprank2_tpu_torch.features``)
                whose ``add_features`` will annotate the graph.
        """
        if not isinstance(feature_modules, list):
            feature_modules = [feature_modules]
        modules = [importlib.import_module(f"deeprank2_tpu_torch.features.{m}") if isinstance(m, str) else m for m in feature_modules]
        self._pssm_required = conservation in modules
        graph = self._build_helper()
        graph.targets.update(self.targets)
        for module in modules:
            module.add_features(self.pdb_path, graph, self.variant)
        return graph

    def _build_helper(self) -> Graph:
        raise NotImplementedError  # subclass responsibility

    def get_query_id(self) -> str:
        raise NotImplementedError  # subclass responsibility


@dataclass(kw_only=True)
class SingleResidueVariantQuery(Query):
    """A query that builds a single-residue-variant graph.

    Additional args (vs :class:`Query`): ``variant_residue_number``,
    ``insertion_code``, ``wildtype_amino_acid``, ``variant_amino_acid``.
    """

    variant_residue_number: int
    insertion_code: str | None
    wildtype_amino_acid: AminoAcid
    variant_amino_acid: AminoAcid

    def __post_init__(self):
        super().__post_init__()
        if len(self.chain_ids) != 1:
            msg = f"an SRV query names exactly one chain; got {len(self.chain_ids)}"
            raise ValueError(msg)
        self.variant_chain_id = self.chain_ids[0]

    @property
    def residue_id(self) -> str:
        """Residue number plus insertion code (if any)."""
        if self.insertion_code is not None:
            return f"{self.variant_residue_number}{self.insertion_code}"
        return str(self.variant_residue_number)

    def get_query_id(self) -> str:
        """The full query ID string."""
        return (
            f"{self.resolution}-srv:"
            f"{self.variant_chain_id}:{self.residue_id}:"
            f"{self.wildtype_amino_acid.name}->{self.variant_amino_acid.name}:{self.model_id}"
        )

    def _build_helper(self) -> Graph:
        arrays = self._load_structure()

        variant_residue_index = arrays.find_residue(self.variant_chain_id, self.variant_residue_number, self.insertion_code)
        if variant_residue_index < 0:
            msg = f"{self.pdb_path} has no residue {self.variant_chain_id} {self.residue_id}"
            raise ValueError(msg)
        variant_residue = arrays.residue_view(variant_residue_index)
        self.variant = SingleResidueVariant(variant_residue, self.variant_amino_acid)

        residues = get_surrounding_residues(arrays, variant_residue_index, self.influence_radius)

        if self.resolution == "residue":
            graph = Graph.build_graph(arrays, residues, "residue", self.get_query_id(), self.max_edge_length)
        else:  # atom
            # all atoms of the surrounding amino-acid residues
            keep = residues[arrays.res_aa_ids[residues] >= 0]
            atoms = np.concatenate(
                [np.arange(arrays.res_atom_start[r], arrays.res_atom_start[r] + arrays.res_atom_count[r]) for r in keep]
            ).astype(np.int64)
            graph = Graph.build_graph(arrays, atoms, "atom", self.get_query_id(), self.max_edge_length)

        graph.center = variant_residue.get_center()
        return graph


@dataclass(kw_only=True)
class ProteinProteinInterfaceQuery(Query):
    """A query that builds a protein-protein interface graph."""

    def __post_init__(self):
        super().__post_init__()
        if len(self.chain_ids) != 2:  # noqa: PLR2004
            msg = f"a PPI query names exactly two chains; got {len(self.chain_ids)}"
            raise ValueError(msg)

    def get_query_id(self) -> str:
        """The full query ID string."""
        return f"{self.resolution}-ppi:{self.chain_ids[0]}-{self.chain_ids[1]}:{self.model_id}"

    def _build_helper(self) -> Graph:
        pdb_name = os.path.splitext(os.path.basename(self.pdb_path))[0]
        # the contact structure carries its own id (reference: buildgraph.py:103)
        arrays = get_structure(self.pdb_path, f"contact_atoms_{pdb_name}")

        contact_atoms = get_contact_atoms(arrays, self.chain_ids, self.influence_radius)
        if len(contact_atoms) == 0:
            msg = f"no atoms within {self.influence_radius} Å across chains {self.chain_ids} of {self.pdb_path}"
            raise ValueError(msg)

        if self.resolution == "atom":
            graph = Graph.build_graph(arrays, contact_atoms, "atom", self.get_query_id(), self.max_edge_length)
        else:
            residues = np.unique(arrays.atom_residue[contact_atoms])
            graph = Graph.build_graph(
                arrays,
                residues,
                "residue",
                self.get_query_id(),
                self.max_edge_length,
                atom_subset=contact_atoms,
            )

        graph.center = arrays.positions[contact_atoms].mean(axis=0)
        if self._pssm_required:
            self._load_pssm_data(arrays)
        return graph


class QueryCollection:
    """A collection of queries to be processed into one dataset.

    Mirrors the reference API (deeprank2/query.py:371): ``add`` dedups query ids
    by renaming, ``process`` runs the multiprocessing featurization fan-out.
    """

    def __init__(self):
        self._queries: list[Query] = []
        self._ids_count: dict[str, int] = {}
        self._prefix: str | None = None
        self._cpu_count: int | None = None
        self._grid_settings: GridSettings | None = None
        self._grid_map_method: MapMethod | None = None
        self._grid_augmentation_count: int = 0

    def add(self, query: Query, verbose: bool = False, warn_duplicate: bool = True) -> None:
        """Add a query; duplicate ids get renamed with a repeat suffix."""
        query_id = query.get_query_id()
        if verbose:
            _log.info(f"adding query {query_id}")

        seen = self._ids_count.get(query_id, 0) + 1
        self._ids_count[query_id] = seen
        if seen > 1:
            query.model_id = f"{query.model_id}_{seen}"
            if warn_duplicate:
                _log.warning(f"duplicate query id {query_id}: renamed to {query.get_query_id()}")

        self._queries.append(query)

    def export_dict(self, dataset_path: str) -> None:
        """Pickle the whole collection."""
        with open(dataset_path, "wb") as fh:
            pickle.dump(self, fh)

    @property
    def queries(self) -> list[Query]:
        """The list of added queries."""
        return self._queries

    def __contains__(self, query: Query) -> bool:
        return query in self._queries

    def __iter__(self):
        return iter(self._queries)

    def __len__(self) -> int:
        return len(self._queries)

    def _process_one_query(self, query: Query, log_error_traceback: bool = False, store: MemoryStore | None = None) -> None:
        """Build one query and append to this process's own HDF5 shard (or
        to ``store``)."""
        try:
            shard = f"{self._prefix}-{os.getpid()}.hdf5" if store is None else store  # one writer per worker PID
            graph = query.build(self._feature_modules)
            graph.write_to_hdf5(shard)

            if self._grid_settings is not None and self._grid_map_method is not None:
                graph.write_as_grid_to_hdf5(shard, self._grid_settings, self._grid_map_method)
                for _ in range(self._grid_augmentation_count):
                    axis, angle = random_rotation_axis_angle(random.randrange(100))
                    graph.write_as_grid_to_hdf5(shard, self._grid_settings, self._grid_map_method, Augmentation(axis, angle))

        except (ValueError, AttributeError, KeyError, TimeoutError, OSError) as e:
            # OSError (incl. FileNotFoundError for missing pdb/pssm files) is
            # trapped too so one bad path never kills a whole processing run —
            # the reference's narrower tuple (query.py:472) lets it propagate.
            _log.warning(
                f"query {query.get_query_id()} failed and was left out of the hdf5 output "
                f"({e.__class__.__name__}: {e}); the rest of the run continues without it",
            )
            if log_error_traceback:
                _log.exception(f"full traceback for {query.get_query_id()}:")

    def process(
        self,
        prefix: str = "processed-queries",
        feature_modules: list[ModuleType | str] | ModuleType | str | None = None,
        cpu_count: int | None = None,
        combine_output: bool = True,
        grid_settings: GridSettings | None = None,
        grid_map_method: MapMethod | None = None,
        grid_augmentation_count: int = 0,
        log_error_traceback: bool = False,
        mp_context: str | None = None,
        num_hosts: int | None = None,
        host_index: int | None = None,
        resume: bool = False,
    ) -> list[str]:
        """Render queries into graphs (and optionally grids) in parallel.

        Same parameters and defaults as the reference (query.py:481-569), plus:

        - ``mp_context``: multiprocessing start method ("fork"/"spawn"/
          "forkserver"). Defaults to "spawn" when CUDA is already initialized
          in this process (a child forked after CUDA has started must never
          touch the device), else "fork".
        - ``num_hosts``/``host_index``: multi-host fan-out — this host
          processes ``queries[host_index::num_hosts]`` and writes
          ``<prefix>-host<h>.hdf5`` (single-writer-per-file discipline, like
          the per-PID worker shards). Defaults follow
          ``torch.distributed.get_world_size()/get_rank()`` when a process
          group is initialized, else 1/0. Feed all per-host files to
          ``GraphDataset``/``GridDataset`` (they accept lists) — no cross-host
          merge step is needed.
        - ``resume``: skip queries whose entry already exists in this prefix's
          output files — checkpoint-restart for interrupted runs (the
          reference has no processing elasticity; SURVEY §5.3).
        """
        import h5py
        import torch

        self._prefix = re.sub(".hdf5$", "", prefix) if prefix else "processed-queries"

        if num_hosts is None or host_index is None:
            num_hosts, host_index = 1, 0
            if torch.distributed.is_available() and torch.distributed.is_initialized():
                num_hosts = torch.distributed.get_world_size()
                host_index = torch.distributed.get_rank()
        if not 0 <= host_index < num_hosts:
            msg = f"host_index {host_index} out of range for num_hosts {num_hosts}"
            raise ValueError(msg)
        host_queries = self.queries[host_index::num_hosts]
        if num_hosts > 1:
            self._prefix = f"{self._prefix}-host{host_index}"

        available_cpus = os.cpu_count()
        self._cpu_count = available_cpus if cpu_count is None else min(cpu_count, available_cpus)
        if cpu_count and self._cpu_count < cpu_count:
            _log.warning(f"requested {cpu_count} workers but the machine has {available_cpus} CPUs; using {self._cpu_count}")

        self._set_options(feature_modules, grid_settings, grid_map_method, grid_augmentation_count)

        if mp_context is None:
            mp_context = "spawn" if torch.cuda.is_initialized() else "fork"
        preexisting: set[str] = set()
        if resume:
            for path in glob(f"{self._prefix}.hdf5") + glob(f"{self._prefix}-*.hdf5"):
                try:
                    with h5py.File(path, "r") as f:
                        preexisting.update(f.keys())
                except OSError:
                    continue
            skipped = [q for q in host_queries if q.get_query_id() in preexisting]
            host_queries = [q for q in host_queries if q.get_query_id() not in preexisting]
            if skipped:
                _log.info(f"resume: skipping {len(skipped)} already-processed queries.")

        # the host kernels build here, once: a failed build raises in the
        # caller, and forked workers find the libraries built
        _build.build_host()
        if self._cpu_count == 1:
            # single worker: run in-process. Same single-writer-per-file
            # semantics (one PID, one shard), none of the start-method
            # hazards (spawn re-imports the caller's __main__).
            for query in host_queries:
                self._process_one_query(query, log_error_traceback=log_error_traceback)
        else:
            from functools import partial

            with multiprocessing.get_context(mp_context).Pool(self._cpu_count) as pool:
                pool.map(partial(self._process_one_query, log_error_traceback=log_error_traceback), host_queries)

        shard_paths = glob(f"{self._prefix}-*.hdf5")
        if combine_output:
            combined = f"{self._prefix}.hdf5"
            for shard in shard_paths:
                with h5py.File(combined, "a") as dest, h5py.File(shard, "r") as src:
                    for entry in src.values():
                        src.copy(entry, dest)
                os.remove(shard)
            return glob(combined)

        # count only entries produced by THIS run: on resume the shard files
        # still hold previously processed entries, which would otherwise mask
        # failures (or report >100% processed)
        n_processed = 0
        for shard in shard_paths:
            with h5py.File(shard, "r") as fh:
                n_processed += sum(1 for key in fh if key not in preexisting)

        if not n_processed:
            msg = "every query failed; nothing was written (rerun with log_error_traceback=True for details)"
            raise ValueError(msg)
        if n_processed != len(host_queries):
            _log.warning(
                f"{n_processed}/{len(host_queries)} queries succeeded; the rest were skipped "
                "(rerun with log_error_traceback=True for per-query tracebacks)",
            )
        return shard_paths

    def _set_options(self, feature_modules, grid_settings, grid_map_method, grid_augmentation_count: int) -> None:
        """The featurization options ``process`` and ``process_in_memory`` share."""
        self._feature_modules = self._set_feature_modules(feature_modules or [components, contact])
        self._grid_settings = grid_settings
        self._grid_map_method = grid_map_method

        if grid_augmentation_count < 0:
            msg = f"grid_augmentation_count must be >= 0, got {grid_augmentation_count}"
            raise ValueError(msg)
        self._grid_augmentation_count = grid_augmentation_count

    def process_in_memory(
        self,
        feature_modules: list[ModuleType | str] | ModuleType | str | None = None,
        grid_settings: GridSettings | None = None,
        grid_map_method: MapMethod | None = None,
        grid_augmentation_count: int = 0,
        log_error_traceback: bool = False,
    ) -> MemoryStore:
        """:meth:`process` without files, for machines without h5py: every
        query built in this process (as ``process`` with ``cpu_count=1``)
        and written, in the layout ``process`` writes, into one
        ``utils/store.py:MemoryStore``, which ``GraphDataset`` and
        ``GridDataset`` take in place of a path. A query that fails is left
        out, with the same warning."""
        self._set_options(feature_modules, grid_settings, grid_map_method, grid_augmentation_count)
        _build.build_host()
        store = MemoryStore()
        for query in self.queries:
            self._process_one_query(query, log_error_traceback=log_error_traceback, store=store)
        if not len(store):
            msg = "every query failed; nothing was written (rerun with log_error_traceback=True for details)"
            raise ValueError(msg)
        return store

    def _set_feature_modules(self, feature_modules: list[ModuleType | str] | ModuleType | str) -> list[str]:
        """Normalize ``feature_modules`` to a list of module-name strings."""
        def name_of(m: ModuleType | str) -> str:
            if isinstance(m, ModuleType):
                return os.path.splitext(os.path.basename(m.__file__))[0]
            if isinstance(m, str):
                return re.sub(".py$", "", m)
            msg = f"feature modules are given as module objects or name strings; got {type(m)}"
            raise TypeError(msg)

        if feature_modules == "all":
            return [modname for _, modname, _ in pkgutil.iter_modules(deeprank2_tpu_torch.features.__path__)]
        if isinstance(feature_modules, list):
            return [name_of(m) for m in feature_modules]
        return [name_of(feature_modules)]
