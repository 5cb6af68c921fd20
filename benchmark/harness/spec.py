"""What a run reads by name: its cell in ``BENCHMARK.json``, the cell's
configuration file, its traffic file (``workloads/<traffic>.json``), its
limits (``limits/<cell>.json``), the model module (``models/<model>.py``),
the input kind that the traffic names (``inputs/<kind>.py``) and one
reader a metric (``metrics/<name>.py``). A new configuration,
traffic mix, cell or metric is a new file and a new entry; nothing here
names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent.parent
PHASES = ("train", "score")


@dataclass
class Metric:
    name: str
    unit: str
    reader: ModuleType
    phase: str | None  # the name's last part when it names a phase


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    model: ModuleType
    inputs: ModuleType
    chips: int
    end_to_end: list[Metric] = field(default_factory=list)
    per_layer: list[Metric] = field(default_factory=list)

    @property
    def phase(self) -> str:
        return self.traffic["phase"]


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> tuple[ModuleType, str | None]:
    """The reader of metric ``name``: ``metrics/<name>.py``, else that of
    the longest dotted prefix of the name that has one. Of the parts after
    it, one may name a phase (``train``, ``score``), which is handed to the
    reader; the others only tell apart metrics of different cells
    (``train_samples_per_s.grids``)."""
    parts = name.split(".")
    for cut in range(len(parts), 0, -1):
        path = bench_dir / "metrics" / f"{'.'.join(parts[:cut])}.py"
        if path.exists():
            phases = [p for p in parts[cut:] if p in PHASES]
            if len(phases) > 1:
                break
            return _load_module(path, f"bench_metric_{'.'.join(parts[:cut])}"), (phases[0] if phases else None)
    msg = f"metric {name!r} has no reader under {bench_dir / 'metrics'}"
    raise FileNotFoundError(msg)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path, bench_dir: Path = BENCH_DIR, traffic_override: dict | None = None) -> Cell:
    """Cell ``name`` of ``root/BENCHMARK.json`` with everything it names."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        msg = f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})"
        raise KeyError(msg)
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "workloads" / f"{entry['traffic']}.json").read_text())
    traffic.update(traffic_override or {})
    limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())["limits"]
    model = _load_module(bench_dir / "models" / f"{config['model']}.py", f"bench_model_{config['model']}")
    kind = _load_module(bench_dir / "inputs" / f"{traffic['inputs']}.py", f"bench_inputs_{traffic['inputs']}")

    def metrics(kind: str) -> list[Metric]:
        return [Metric(m["name"], m["unit"], *metric_reader(m["name"], bench_dir)) for m in bench[kind] if _applies(m, name)]

    return Cell(name, config, traffic, limits, model, kind, int(entry["chips"]), metrics("end_to_end"), metrics("per_layer"))
