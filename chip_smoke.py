"""Smoke run of the PyTorch/CUDA port (deeprank2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device and build: the card, torch and CUDA versions, and the nvcc build of
   every kernel source of the main path (with ptxas's register report);
2. kernels against their plain PyTorch versions on the card, at the main
   path's shapes (G=512 graphs of N=160 nodes, F=32 and 64) and at a ragged
   shape (G=7, N=96, F=38, padded nodes masked), rtol=atol=1e-5 (both f32,
   only the summation order differs); then each kernel's time at the main
   path's calls beside its plain version, one library call of the same
   contraction, and its bound;
3. the main path: GINetDense(38, 2, 6) on the bench batch
   (synthetic_entries(512, 160, 38, 6, seed=7)). First one dropout-free step
   is held against the same step on the CPU (logits, loss and every gradient
   at rtol=1e-4, atol=1e-6). Then, with the launch counters set to 0, STEPS
   train steps (CrossEntropy, backward, Adam lr 1e-3 wd 1e-5, dropout from a
   seeded generator) and one eval forward; the counters must read
   3*STEPS + 2 (diag_kernel) and STEPS (pool_bwd_kernel);
4. a profile of a few train steps: device time by kernel, idle share.

Then the ``kernels`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without CUDA, or without the package beside this file, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
STEPS = 20
WARM_STEPS = 4
BENCH = {"num_graphs": 512, "nodes": 160, "feat": 38, "edge_dim": 6, "seed": 7}
TOL = {"rtol": 1e-5, "atol": 1e-5}
STEP_TOL = {"rtol": 1e-4, "atol": 1e-6}
# the main path's calls of each kernel in one train step: (kernel, mode, F)
STEP_CALLS = [("diag_kernel", "relu_mask", 32), ("diag_kernel", "relu_mask_pool", 64), ("diag_kernel", "plain", 32), ("pool_bwd_kernel", None, 64)]
REPLACES = {
    "diag_kernel": "deeprank2_tpu/ops/diag_spmm.py:113 (_diag_kernel, pallas_call at :188)",
    "pool_bwd_kernel": "deeprank2_tpu/ops/diag_spmm.py:263 (_pool_bwd_kernel, pallas_call at :308)",
}
# published peaks (NVIDIA data sheets; dense, f32 outside the tensor cores):
# (memory bytes/s, f32 FLOP/s). The SXM part is the default.
PEAKS = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12), "SXM": (3.35e12, 67e12)}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name: str) -> tuple[str, float, float]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return (key, *PEAKS[key])
    return ("SXM", *PEAKS["SXM"])


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def ragged_entries(synthetic_entries, num_graphs=7, nodes=96, feat=38):
    """Graphs of decreasing size: padded nodes inside real graphs."""
    entries = synthetic_entries(num_graphs, nodes, feat, 6, seed=3)
    for i, e in enumerate(entries):
        v = nodes - (9 * i) % (nodes // 2)
        e["x"], e["pos"] = e["x"][:v], e["pos"][:v]
        e["edge_index"] = e["edge_index"][(e["edge_index"] < v).all(axis=1)]
    return entries


def check_kernels(torch, ds, shapes, dev) -> tuple[list, dict]:
    """Every kernel wrapper against its plain version, directly and through
    the autograd Functions; raises on the first disagreement."""
    errs = {"diag_kernel": 0.0, "pool_bwd_kernel": 0.0}
    checks = []

    def close(kernel, what, got, want):
        err = (got.float() - want.float()).abs().max().item()
        errs[kernel] = max(errs[kernel], err)
        checks.append({"kernel": kernel, "check": what, "max_abs_err": err})
        torch.testing.assert_close(got, want, **TOL, msg=lambda m: f"{kernel} {what}: {m}")

    for tag, adj, mask, feats in shapes:
        gen = torch.Generator(device=dev).manual_seed(len(checks))
        g, n, _ = adj.shape
        for f in feats:
            x = torch.randn(f, g * n, generator=gen, device=dev)
            close("diag_kernel", f"{tag} plain F={f}", ds.diag_kernel(adj, x), ds.diag_kernel_ref(adj, x))
            h_ref = ds.diag_kernel_ref(adj, x, mask, "relu_mask")
            close("diag_kernel", f"{tag} relu_mask F={f}", ds.diag_kernel(adj, x, mask, "relu_mask"), h_ref)
            sign, pooled = ds.diag_kernel(adj, x, mask, "relu_mask_pool")
            sign_ref, pooled_ref = ds.diag_kernel_ref(adj, x, mask, "relu_mask_pool")
            close("diag_kernel", f"{tag} relu_mask_pool pooled F={f}", pooled, pooled_ref)
            # the stored sign may differ only where h is zero to summation order
            flips = ((sign != sign_ref) & (h_ref.abs() > TOL["atol"])).sum().item()
            checks.append({"kernel": "diag_kernel", "check": f"{tag} relu_mask_pool sign F={f}", "sign_flips_clear_of_zero": flips})
            if flips:
                msg = f"diag_kernel pool-mode sign differs from the plain version at {flips} values clear of zero"
                raise AssertionError(msg)
            g_pool = torch.randn(f, g, generator=gen, device=dev)
            close("pool_bwd_kernel", f"{tag} direct F={f}", ds.pool_bwd_kernel(adj, sign_ref, g_pool), ds.pool_bwd_kernel_ref(adj, sign_ref, g_pool))
            # through the autograd Functions: the layer-1 VJP is diag_kernel
            # plain, the pooled layer's VJP is pool_bwd_kernel
            cot = torch.randn(f, g * n, generator=gen, device=dev)
            for layer, kernel, cotangent in (("diag_layer_t", "diag_kernel", cot), ("diag_layer_pool_t", "pool_bwd_kernel", g_pool)):
                xk = x.clone().requires_grad_(True)
                xr = x.clone().requires_grad_(True)
                out_k = getattr(ds, layer)(adj, mask, xk)
                out_r = getattr(ds, f"{layer}_ref")(adj, mask, xr)
                (gk,) = torch.autograd.grad(out_k, xk, cotangent)
                (gr,) = torch.autograd.grad(out_r, xr, cotangent)
                close("diag_kernel", f"{tag} {layer} fwd F={f}", out_k.detach(), out_r.detach())
                close(kernel, f"{tag} {layer} vjp F={f}", gk, gr)
    sync(torch, dev)
    return checks, errs


def card_vs_cpu_step(torch, model, batch, loss_fn, cpu_model_factory) -> dict:
    """One dropout-free step (logits, loss, every gradient) on the model's
    device and on the CPU from the same parameters and batch."""
    cpu_model = cpu_model_factory()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    results = []
    for m, b in ((model, batch), (cpu_model, batch.to("cpu"))):
        m.zero_grad(set_to_none=True)
        logits = m(b, training=False)
        loss = loss_fn(logits, b.y, b.y_mask)
        loss.backward()
        results.append((logits.detach().cpu(), loss.detach().cpu(), {k: p.grad.cpu() for k, p in m.named_parameters() if p.grad is not None}))
    model.zero_grad(set_to_none=True)
    (lg, ls, gr), (lc, lsc, grc) = results
    if gr.keys() != grc.keys():
        msg = f"gradients differ in which parameters have one: {sorted(gr)} vs {sorted(grc)}"
        raise AssertionError(msg)
    errs = {}
    for name, got, want in [("logits", lg, lc), ("loss", ls, lsc), *[(f"grad {k}", gr[k], grc[k]) for k in gr]]:
        torch.testing.assert_close(got, want, **STEP_TOL, msg=lambda m, name=name: f"card vs CPU {name}: {m}")
        errs[name] = (got - want).abs().max().item()
    return {"loss": ls.item(), "max_abs_err": errs}


def run_main_path(torch, ds, model, batch, loss_fn, opt, dev, steps=STEPS, warm=WARM_STEPS) -> dict:
    """``steps`` train steps and one eval forward, with the launch counters
    set to 0 just before and read just after."""
    drop_gen = torch.Generator(device=dev).manual_seed(1)

    def train_step():
        opt.zero_grad(set_to_none=True)
        logits = model(batch, training=True, generator=drop_gen)
        loss = loss_fn(logits, batch.y, batch.y_mask)
        loss.backward()
        opt.step()
        return loss.detach()

    sync(torch, dev)
    ds.reset_launches()
    losses = [train_step() for _ in range(warm)]
    sync(torch, dev)
    t0 = time.perf_counter()
    losses += [train_step() for _ in range(steps - warm)]
    sync(torch, dev)
    step_s = (time.perf_counter() - t0) / (steps - warm)
    with torch.no_grad():
        eval_logits = model(batch, training=False)
    sync(torch, dev)
    launches = dict(ds.launches)
    losses = torch.stack(losses).cpu()
    want = {"diag_kernel": 3 * steps + 2, "pool_bwd_kernel": steps}
    if dev.type == "cuda" and launches != want:
        msg = f"main path launches {launches}, expected {want}"
        raise AssertionError(msg)
    if not torch.isfinite(losses).all() or not torch.isfinite(eval_logits).all() or tuple(eval_logits.shape) != (batch.num_graphs, 2):
        msg = f"non-finite or misshapen results: losses {losses.tolist()}, logits {tuple(eval_logits.shape)}"
        raise AssertionError(msg)
    return {
        "steps": steps,
        "timed_steps": steps - warm,
        "step_s": step_s,
        "loss_first": losses[0].item(),
        "loss_last": losses[-1].item(),
        "launches": launches,
        "launches_expected": want,
        "train_step": train_step,
    }


class Timer:
    """Median CUDA-event time of one call, with the L2 cache flushed before
    each call (the 50 MB L2 would otherwise hold much of a call's inputs)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int = 15) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(reps):
            self.flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def time_step_calls(torch, ds, adj, mask, peak_bw, peak_f32) -> tuple[list, int]:
    """Kernel, plain-version and library times at each call of STEP_CALLS,
    with each call's bound (bytes: inputs read once, outputs written once;
    operations: the products this adjacency's nonzeros need)."""
    timer = Timer(torch)
    g, n, _ = adj.shape
    adj_f32 = adj.float()
    nnz = int(adj.count_nonzero().item())
    gen = torch.Generator(device="cuda").manual_seed(11)
    calls = []
    for kernel, mode, f in STEP_CALLS:
        x = torch.randn(f, g * n, generator=gen, device="cuda")
        x_gnf = x.reshape(f, g, n).permute(1, 2, 0).contiguous()
        if kernel == "diag_kernel":
            m = None if mode == "plain" else mask
            run = lambda x=x, m=m, mode=mode: ds.diag_kernel(adj, x, m, mode)  # noqa: E731
            plain = lambda x=x, m=m, mode=mode: ds.diag_kernel_ref(adj, x, m, mode)  # noqa: E731
            in_bytes = adj.numel() + 4 * f * g * n + (0 if mode == "plain" else g * n)
            out_bytes = (f * g * n + 4 * f * g) if mode == "relu_mask_pool" else 4 * f * g * n
        else:
            sign, _ = ds.diag_kernel(adj, x, mask, "relu_mask_pool")
            g_pool = torch.randn(f, g, generator=gen, device="cuda")
            run = lambda sign=sign, g_pool=g_pool: ds.pool_bwd_kernel(adj, sign, g_pool)  # noqa: E731
            plain = lambda sign=sign, g_pool=g_pool: ds.pool_bwd_kernel_ref(adj, sign, g_pool)  # noqa: E731
            in_bytes = adj.numel() + f * g * n + 4 * f * g
            out_bytes = 4 * f * g * n
        library = lambda x_gnf=x_gnf: torch.bmm(adj_f32, x_gnf)  # noqa: E731
        flop = 2 * f * nnz
        t_bytes, t_ops = (in_bytes + out_bytes) / peak_bw, flop / peak_f32
        calls.append(
            {
                "kernel": kernel,
                "mode": mode or "pool_bwd",
                "F": f,
                "ms": timer.ms(run),
                "plain_ms": timer.ms(plain),
                "library_ms": timer.ms(library),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": in_bytes + out_bytes,
                "flop_needed": flop,
                "flop_dense": 2 * f * n * n * g,
            }
        )
    return calls, nnz


def profile_steps(torch, train_step, step_s, steps=3) -> dict:
    """Device time by kernel over a few traced train steps. The idle share is
    taken against the untraced step time (tracing slows the host) and, for
    comparison, against the traced wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only; user annotations (e.g. Optimizer.step) span gaps between kernels
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and not e.is_user_annotation and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {
        "steps": steps,
        "traced_wall_us_per_step": wall_us / steps,
        "untraced_step_us": step_s * 1e6,
        "device_busy_us_per_step": busy_us / steps,
        "idle_share": max(0.0, 1 - busy_us / steps / (step_s * 1e6)),
        "idle_share_traced": max(0.0, 1 - busy_us / wall_us),
        "top": [{"name": e.key[:90], "device_us_per_step": e.self_device_time_total / steps, "launches_per_step": e.count / steps} for e in top],
    }


def kernels_line(calls, launches, errs) -> list:
    kernels = []
    for name in ("diag_kernel", "pool_bwd_kernel"):
        mine = [c for c in calls if c["kernel"] == name]
        kernels.append(
            {
                "name": name,
                "route": "cuda",
                "source": "deeprank2_tpu_torch/csrc/diag_spmm.cu",
                "replaces": REPLACES[name],
                "launches": launches[name],
                "max_abs_err": errs[name],
                "per": "one train step: " + ", ".join(f"{c['mode']} F={c['F']}" for c in mine),
                "ms": sum(c["ms"] for c in mine),
                "kernel_ms": sum(c["ms"] for c in mine),
                "plain_ms": sum(c["plain_ms"] for c in mine),
                "bound_ms": sum(c["bound_ms"] for c in mine),
                "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c in mine) else "operations",
                "library_ms": sum(c["library_ms"] for c in mine),
                "library": "torch.bmm of the f32 adjacency [G,N,N] with the [G,N,F] slab (contraction only)",
            }
        )
    return kernels


def main() -> int:
    if not (HERE / "deeprank2_tpu_torch").is_dir():
        print("chip_smoke.py: the deeprank2_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke run needs the card", file=sys.stderr)
        return 2

    from deeprank2_tpu_torch.neuralnets.gnn.ginet_dense import GINetDense
    from deeprank2_tpu_torch.ops import _build
    from deeprank2_tpu_torch.ops import diag_spmm as ds
    from deeprank2_tpu_torch.ops.batch import collate_graphs_dense
    from deeprank2_tpu_torch.ops.losses import CrossEntropyLoss
    from deeprank2_tpu_torch.ops.optim import Adam
    from deeprank2_tpu_torch.ops.synthetic import synthetic_entries

    # 1. device and build
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    part, peak_bw, peak_f32 = peaks(kind)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build([ds.SOURCE])
    build_s = time.perf_counter() - t0
    emit(
        {
            "phase": "device_and_build",
            "card": card,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
            "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32, "cudnn": torch.backends.cudnn.allow_tf32},
            "build_s": build_s,
            "ptxas": [ln.strip() for log in _build.build_logs.values() for ln in log.splitlines() if "registers" in ln or "Compiling" in ln],
            "peaks": {"part": part, "bytes_per_s": peak_bw, "f32_flop_per_s": peak_f32},
        }
    )

    # 2. kernels against their plain versions, and their times
    dev = torch.device("cuda")
    entries = synthetic_entries(BENCH["num_graphs"], BENCH["nodes"], BENCH["feat"], BENCH["edge_dim"], seed=BENCH["seed"])
    batch, _ = collate_graphs_dense(entries, pad_graphs=BENCH["num_graphs"], pad_nodes=BENCH["nodes"], device=dev)
    ragged, _ = collate_graphs_dense(ragged_entries(synthetic_entries), pad_nodes=96, device=dev)
    shapes = [("bench G=512 N=160", batch.adj_i8, batch.node_mask, (32, 64)), ("ragged G=7 N=96", ragged.adj_i8, ragged.node_mask, (38,))]
    checks, errs = check_kernels(torch, ds, shapes, dev)
    emit({"phase": "kernels_vs_plain", "tolerance": TOL, "checks": checks})
    calls, nnz = time_step_calls(torch, ds, batch.adj_i8, batch.node_mask, peak_bw, peak_f32)
    emit({"phase": "kernel_times", "card": card, "l2_flushed": True, "adjacency_nnz": nnz, "calls": calls})

    # 3. the main path
    model = GINetDense(BENCH["feat"], 2, BENCH["edge_dim"], device=dev, generator=torch.Generator().manual_seed(0))
    loss_fn = CrossEntropyLoss()
    step = card_vs_cpu_step(torch, model, batch, loss_fn, lambda: GINetDense(BENCH["feat"], 2, BENCH["edge_dim"], device="cpu"))
    emit({"phase": "card_vs_cpu_step", "tolerance": STEP_TOL, **step})
    opt = Adam(model.parameters(), lr=1e-3, weight_decay=1e-5)
    run = run_main_path(torch, ds, model, batch, loss_fn, opt, dev)
    real_edges = int(sum(2 * e["edge_index"].shape[0] for e in entries))
    train_step = run.pop("train_step")
    emit(
        {
            "phase": "main_path",
            "card": card,
            "model": "GINetDense(38, 2, 6)",
            "batch": BENCH,
            **run,
            "step_ms": run["step_s"] * 1e3,
            "edges_per_s": real_edges / run["step_s"],
            "real_edges": real_edges,
        }
    )

    # 4. profile of a few steps (after the counted run)
    emit({"phase": "profile", "card": card, **profile_steps(torch, train_step, run["step_s"])})

    emit({"kernels": kernels_line(calls, run["launches"], errs)})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
