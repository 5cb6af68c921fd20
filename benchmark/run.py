"""The benchmark of ``deeprank2_tpu_torch`` on one H100:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as its last line of standard output,
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number that decided ``correct`` beside its limit), and the same
checks as the last lines of standard error. With ``--trace 0`` the metrics
are the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.
Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, or if a module of JAX or of the JAX package was loaded."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark.harness import program, spec

    program.set_cache_dirs(ROOT)
    import torch

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from benchmark.harness import core

    out = core.run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    result = out["result"]
    print(json.dumps({"extras": out["extras"]}, default=float), file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
