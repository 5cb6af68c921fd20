"""The multi-device dry run (the port's counterpart of the JAX package's
``__graft_entry__.py:dryrun_multichip``): every parallel path once over
``--ranks`` processes of one process group, each against the same model on
one rank, then the collectives of each path.

    python -m deeprank2_tpu_torch.tools.dryrun_multichip --ranks 2 --backend gloo --device cuda [--out FILE]

On CUDA every kernel is built here, before the ranks start (the build takes
no file lock); the ranks share the host's cards (``cuda:{rank % count}``).
It prints one summary line (each path's loss and ``max_err``), one
``comm[...]`` line a report, as the JAX dry run does, and one JSON object
with everything (also written to FILE); it exits 1 when a loss is not
finite or a ``max_err`` reaches ``--tol`` (1e-4, the JAX dry run's).
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from deeprank2_tpu_torch.parallel import launch, probes

DP_PATHS = ("dp", "dense_dp", "blocked_edge_dp", "clustered_bs_dp", "diag_clustered_dp", "mixed_region_dp")
FORWARD_PATHS = ("edge_partition", "ring_halo", "blocksparse_partition", "blocksparse_ring")


def build_kernels() -> None:
    """Build every CUDA source of the package in this process."""
    from deeprank2_tpu_torch.ops import _build

    _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))


def comm_line(report: dict) -> str:
    parts = [f"{op}: {s['count']}x {s['bytes'] / 1e3:.1f}kB" for op, s in report.items() if isinstance(s, dict) and s.get("count")]
    return f"comm[{report['path']} @ {report['shards']}]: " + (", ".join(parts) or "no collectives")


def run(ranks: int, backend: str, device: str, per_shard: int = 2, nodes: int = 24, timeout: float = 300.0, deadline: float = 900.0) -> dict:
    """Every rank's :func:`probes.dryrun_paths`, rank 0's results first."""
    if device == "cuda":
        build_kernels()
    spec = {"device": device, "per_shard": per_shard, "nodes": nodes}
    results = launch.run(probes.dryrun_paths, ranks, spec, backend=backend, timeout=timeout, deadline=deadline)
    return {"ranks": ranks, "backend": backend, "device": device, "paths": {p: results[0][p] for p in (*DP_PATHS, *FORWARD_PATHS)}, "comm": results[0]["comm"]}


def summary(report: dict, tol: float) -> tuple[bool, list[str]]:
    paths = report["paths"]
    ok = all(math.isfinite(paths[p]["loss"]) for p in DP_PATHS) and all(paths[p]["max_err"] < tol for p in paths)
    fields = [f"{p} loss={paths[p]['loss']:.4f} max_err={paths[p]['max_err']:.2e}" for p in DP_PATHS]
    fields += [f"{p} max_err={paths[p]['max_err']:.2e}" for p in FORWARD_PATHS]
    head = f"dryrun_multichip {'OK' if ok else 'FAILED'} on {report['ranks']} ranks ({report['backend']}, {report['device']}); " + ", ".join(fields)
    return ok, [head, *(comm_line(report["comm"][k]) for k in ("dp", "edge", "ring", "blocksparse_ring"))]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--tol", type=float, default=1e-4)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    report = run(args.ranks, args.backend, args.device)
    ok, lines = summary(report, args.tol)
    print("\n".join(lines))
    text = json.dumps(report)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
