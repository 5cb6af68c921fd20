"""The readings that a cell's limits are set from (not part of the
benchmark's runs):

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 ... [--seconds 2] [--out FILE]

For each seed, one run of the cell at its own sizes with a short window,
in this one process: the program's numbers against the reference (the
lower readings), and, put in the program's place, the control (the
reference in TF32, the precision below the configuration's f32 with TF32
off) and the cell's faults (a train cell: half of each batch left out of
the loss, the mean over the rest, in every pass or in the train step's
gradient alone; the state left unchanged; a score cell: one answer
altered), each against the reference (the upper readings).
Prints, and appends to ``--out``, one JSON line a seed."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark.harness import core, program, spec

    program.set_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    for seed in args.seeds:
        out = core.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0), controls=True)
        line = {
            "workload": args.workload,
            "seed": seed,
            "correct": out["result"]["correct"],
            "numbers": out["extras"]["numbers"],
            "readings": out["extras"]["readings"],
            "metrics": out["result"]["metrics"],
            "reference_s": out["extras"]["reference_s"],
            "setup_marks": out["extras"]["setup_marks"],
        }
        text = json.dumps(line, default=float)
        print(text, flush=True)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with args.out.open("a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
