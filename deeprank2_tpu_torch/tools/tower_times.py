"""The fused tower kernels' times on the card, by CUDA events and on the device.

Times K8f and K8b (``ops/ginet_tower.py``) and K9f and K9b
(``ops/diag_spmm.py``) in both forms on the inputs of ``chip_smoke.py``'s
tower phases: the dense bench batch (``synthetic_entries(512, 160, 38, 6, seed=7)``,
collated dense), GINetDense(38, 2, 6)'s fused weights from torch seed 0, the
cotangent of the pooled sums from a seeded generator, and K9b on the plain
version's h1 and sign. For each call it reports, with ``chip_smoke.py``'s
yardstick (``tools/timing.py:Timer``), the median CUDA-event time with the
L2 flushed before each call (``ms``: the host's launch included) and the
device time of the call's own kernels from the profiler (``device_ms``: the
flush's kernel left out). It calls only the wrappers that every version of
the package since the towers were ported has, so it also times an older
checkout: copy this file and ``timing.py`` into that checkout's
``deeprank2_tpu_torch/tools/`` and run it from there.

    python -m deeprank2_tpu_torch.tools.tower_times [--out FILE]

prints one JSON object (and writes it to FILE). Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

import deeprank2_tpu_torch
from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
from deeprank2_tpu_torch.ops import diag_spmm as ds
from deeprank2_tpu_torch.ops import ginet_tower as gt
from deeprank2_tpu_torch.ops.batch import collate_graphs_dense
from deeprank2_tpu_torch.ops.synthetic import synthetic_entries
from deeprank2_tpu_torch.tools.timing import Timer

BENCH = {"num_graphs": 512, "nodes": 160, "feat": 38, "edge_dim": 6, "seed": 7}


def tower_times(dev: torch.device) -> list:
    entries = synthetic_entries(BENCH["num_graphs"], BENCH["nodes"], BENCH["feat"], BENCH["edge_dim"], seed=BENCH["seed"])
    b, _ = collate_graphs_dense(entries, pad_graphs=BENCH["num_graphs"], pad_nodes=BENCH["nodes"], device=dev)
    model = GINetDense(BENCH["feat"], 2, BENCH["edge_dim"], device=dev, generator=torch.Generator().manual_seed(0))
    w1_t, w2_t = model.fused_weights()
    w1, w2 = w1_t.detach().T.contiguous(), w2_t.detach().T.contiguous()
    dp = torch.randn(b.x.shape[0], w2.shape[1], generator=torch.Generator(device=dev).manual_seed(16), device=dev)
    g_pool = dp.T.contiguous()
    args = (w1, w2, b.x, b.adj_i8, b.node_mask)
    fargs = (b.adj_i8, b.x_t, b.node_mask, w1, w2)
    timer = Timer(dev)
    rows = []
    for cd in (None, torch.bfloat16):
        h1, sign, _ = ds.tower_fwd_kernel_ref(*fargs, cd)
        calls = {
            "ginet_tower_fwd_kernel": lambda cd=cd: gt.ginet_tower_fwd_kernel(*args, cd),
            "ginet_tower_bwd_kernel": lambda cd=cd: gt.ginet_tower_bwd_kernel(*args, dp, cd),
            "tower_fwd_kernel": lambda cd=cd: ds.tower_fwd_kernel(*fargs, cd),
            "tower_bwd_kernel": lambda cd=cd, h1=h1, sign=sign: ds.tower_bwd_kernel(b.adj_i8, g_pool, sign, h1, w2, cd),
        }
        for kernel, fn in calls.items():
            rows.append({"kernel": kernel, "form": ds.form_name(torch.int8, ds.activation_dtype(cd)), "ms": timer.ms(fn), **timer.launch_ms(fn, {"device_ms": ""})})
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON object to this file")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("tower_times: no CUDA device", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=False)
    out = {
        "card": smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else torch.cuda.get_device_name(0),
        "package": deeprank2_tpu_torch.__file__,
        "shape": [BENCH["num_graphs"], BENCH["nodes"], BENCH["nodes"]],
        "l2_flushed": True,
        "calls": tower_times(torch.device("cuda")),
    }
    text = json.dumps(out)
    print(text, flush=True)
    if opts.out:
        with open(opts.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
