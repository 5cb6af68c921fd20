"""A whole run loads no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``deeprank2_tpu`` (compared whole: ``deeprank2_tpu_torch`` is
the port), and the reference imports nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.tests.conftest import ROOT

BLOCKER = """
import importlib.abc, sys
FORBIDDEN = {"jax", "jaxlib", "flax", "deeprank2_tpu"}
tried = []
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            tried.append(name)
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, ".")
"""


def _run(body: str) -> dict:
    code = BLOCKER + body + "\nimport json; print(json.dumps({'tried': tried, 'top': sorted({m.split('.')[0] for m in sys.modules})}))"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_whole_run_loads_no_jax():
    found = _run(
        "import torch\n"
        "from benchmark import run, calibrate\n"
        "from benchmark.tests.conftest import run_tiny\n"
        "for cell in ('vanilla_residue.train', 'cnn_grid.train', 'cnn_grid.score'):\n"
        "    for trace in (False, True):\n"
        "        assert run_tiny(cell, trace=trace)['result']['correct']\n"
    )
    assert not found["tried"]
    assert not set(found["top"]) & {"jax", "jaxlib", "flax", "deeprank2_tpu"}
    assert "deeprank2_tpu_torch" in found["top"]


def test_reference_imports_nothing_of_the_program():
    found = _run("import benchmark.reference.vanilla_gnn, benchmark.reference.cnn3d, benchmark.reference.train\n")
    assert "deeprank2_tpu_torch" not in found["top"]
    assert not found["tried"]
