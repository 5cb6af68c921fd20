"""One run of one cell: set-up, the measured window, the check of what the
window's path produced, and the result line.

Set-up (all of it counted in ``setup_s``): build or load the cell's CUDA
libraries, make the inputs (the traffic's input kind, ``inputs/<kind>.py``)
and the weights from the seed, lay the inputs out for the port's dataset
(with the configuration's ``dataset_args``), build the Trainer (with its
``trainer_args``), and run its first call. In a train cell that call is
``Trainer.train(nepoch=1, **train_args)``, the traffic's ``train_args``
over ``shuffle=False``: a forward over the training set (the Trainer's
epoch 0) and one Adam step a batch, whose outputs, parameters and moments
are kept for the check; unshuffled, it fills the Trainer's collate cache,
which serves every later pass. In a score cell it is one
``Trainer.test``. Then ``warmup_calls`` more calls of the window's own
kind.

The window calls ``Trainer.train(nepoch=epochs_per_call)`` (or
``Trainer.test``) until ``seconds`` have passed, and closes once the device
has finished. With ``trace`` it runs under ``torch.profiler``.

After it: the peak memory, the check that no module of JAX was loaded, the
program freed, then the reference on the same inputs and weights, and the
numbers of ``gate`` beside their limits."""

from __future__ import annotations

import contextlib
import gc
import math
import os
import shutil
import sys
import tempfile
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import gate, peaks, program
from benchmark.harness import trace as tracing
from benchmark.harness.spec import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "deeprank2_tpu")


def process_start_epoch() -> float:
    """The time this process started, from ``/proc`` (10 ms ticks)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        btime = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines() if line.startswith("btime"))
        return btime + int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, StopIteration, IndexError, ValueError):
        return time.time()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def make_weights(shapes: dict, seed: int, device: torch.device) -> dict:
    """Every parameter from one uniform draw on the device: ``U(-b, b)``,
    ``b = 1/sqrt(fan-in)``, the port's and the reference's initialisation;
    host copies by name."""
    gen = torch.Generator(device=device).manual_seed(seed + 0x9E3779B9)
    total = sum(math.prod(shape) for shape, _ in shapes.values())
    draw = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for name, (shape, fan_in) in shapes.items():
        n = math.prod(shape)
        out[name] = (draw[at : at + n] / math.sqrt(fan_in)).reshape(shape).cpu()
        at += n
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pass_kind(stat: dict) -> str:
    """``train``, ``eval`` (the Trainer's epoch-0 forward in ``train``) or ``score``."""
    if stat["pass"] == "testing":
        return "score"
    return "train" if stat["epoch"] >= 1 else "eval"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, controls: bool = False) -> dict:
    """The result of one run; ``controls`` adds the control's and the
    faults' readings (``calibrate.py``), which the benchmark's runs skip."""
    started = process_start_epoch()
    traffic, config, model = cell.traffic, cell.config, cell.model
    batch_size, phase = int(traffic["batch_size"]), cell.phase
    warnings.filterwarnings("ignore", message="A model has been saved")
    extras: dict = {"setup_marks": {}}
    tmp = Path(tempfile.mkdtemp(prefix="bench-"))

    def mark(what: str) -> None:
        _sync(device)
        extras["setup_marks"][what] = time.time() - started

    mark("imports")

    extras["build_s"] = program.build_kernels(model.KERNEL_SOURCES) if device.type == "cuda" else 0.0
    mark("build")
    data_in = cell.inputs.make(batch_size * int(traffic["batches"]), traffic, config, seed, device)
    weights = make_weights(model.parameter_shapes(config), seed, device)
    mark("inputs")
    names = program.entry_names(data_in.count)
    dataset = program.dataset(cell.inputs, data_in, config.get("dataset_args"))
    mark("dataset")
    exporter = program.capture_exporter(str(tmp / "exporter"), seed)
    model_cls = program.port_class(model.PORT_CLASS)
    epochs = int(traffic.get("epochs_per_call", 1))

    import deeprank2_tpu_torch.trainer  # noqa: F401 — its import apart from the Trainer's construction in the marks

    mark("port_import")
    if phase == "train":
        trainer = program.train_trainer(model_cls, dataset, weights, exporter, seed, device, config.get("trainer_args"))
        mark("trainer")
        train_args = {"shuffle": False, **traffic.get("train_args", {})}

        def call(nepoch: int = epochs) -> None:
            trainer.train(nepoch=nepoch, batch_size=batch_size, best_model=False, filename=None, **train_args)

        exporter.keep = "all"
        call(1)
        mark("first_call")
        exporter.keep = None
        prog = program.snapshot(trainer)
        # the train pass's order: its exported names (the order the steps took the entries in)
        by_epoch = {epoch: (list(got), np.asarray(out, dtype=np.float64)) for _, epoch, got, out, _ in exporter.passes}
        index = {name: i for i, name in enumerate(names)}
        order = np.asarray([index[n] for n in by_epoch[1][0]], dtype=np.int64) if 1 in by_epoch and sorted(by_epoch[1][0]) == names else np.arange(len(names))
        eval_ok = 0 in by_epoch and by_epoch[0][0] == names
        train_ok = 1 in by_epoch and len(by_epoch[1][0]) == len(names)
        prog["train_probs"] = by_epoch[1][1] if train_ok else None
        prog["eval_losses"] = gate.batch_losses(by_epoch[0][1], data_in.y, batch_size) if eval_ok else []
        prog["train_losses"] = gate.batch_losses(by_epoch[1][1], data_in.y[order], batch_size) if train_ok else []
        prog["reported_eval_loss"] = next((loss for _, epoch, _, _, loss in exporter.passes if epoch == 0), None)
        exporter.passes.clear()
        per_call = epochs * data_in.count
    else:
        trainer = program.score_trainer(model_cls, dataset, weights, exporter, config, tmp, device, config.get("trainer_args"))
        mark("trainer")

        def call() -> None:
            trainer.test(batch_size=batch_size)

        exporter.keep = "all"
        call()
        mark("first_call")
        exporter.keep = "sample"
        per_call = data_in.count
    for _ in range(int(traffic.get("warmup_calls", 1))):
        call()
    mark("warmup")

    # the window
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    first_stat, first_pass = len(trainer.pass_stats), exporter.count
    nonfinite_before = exporter.nonfinite
    profiler = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else []))
    calls = 0
    with profiler as prof:
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            setup_s = time.time() - started
            t0 = time.perf_counter()
            while True:
                call()
                calls += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            _sync(device)
            window_s = time.perf_counter() - t0
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    stats = trainer.pass_stats[first_stat:]
    window_passes = exporter.count - first_pass
    nonfinite = exporter.nonfinite - nonfinite_before
    found = forbidden_modules()
    if found:
        msg = f"modules of JAX or the JAX package were loaded: {found}"
        raise SystemExit(msg)
    t_reduce = time.perf_counter()
    summary = tracing.reduce(prof) if trace else None
    extras["trace_reduce_s"] = time.perf_counter() - t_reduce
    del prof, profiler

    # the program is freed before the reference runs
    score_passes = [(got, np.asarray(out, dtype=np.float64)) for _, _, got, out, _ in exporter.kept()] if phase == "score" else []
    exporter.passes.clear()
    del trainer, dataset, exporter
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    dev_weights = {k: v.to(device) for k, v in weights.items()}
    batches = model.batches(data_in, batch_size, device)
    from benchmark.reference import train as ref_train

    readings: dict = {}
    if phase == "train":
        train_batches = model.batches(data_in, batch_size, device, order)

        def follow(forward=model.forward, params=dev_weights, **fault) -> dict:
            return ref_train.follow(forward, params, batches, train_batches, config["optimizer"], **fault)

        def held(side: dict, leaves_too: bool = False) -> dict:
            return gate.train_numbers(side, ref, weights, order, batch_size, leaves_too=leaves_too)

        ref = follow()
        numbers = held(prog, leaves_too=controls)
        if controls:
            unchanged = {**prog, "params": weights, "train_probs": ref["eval_probs"][order]}

            def in_f64(params, batch):
                return model.forward(params, {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v for k, v in batch.items()})

            readings = {
                "control_tf32": held(follow(tf32=True), leaves_too=True),
                "fault_half_batch": held(follow(report_share=0.5, step_share=0.5)),
                "fault_step_half_batch": held(follow(step_share=0.5)),
                "fault_state_unchanged": held(unchanged),
                "reference_f64": held(follow(in_f64, {k: v.double() for k, v in dev_weights.items()}), leaves_too=True),
            }
    else:
        ref_probs = ref_train.score(model.forward, dev_weights, batches).numpy()
        numbers = gate.score_numbers(score_passes, names, ref_probs)
        if controls:
            ctl = ref_train.score(model.forward, dev_weights, batches, tf32=True).numpy()
            altered = score_passes[-1][1].copy()
            k = int(np.random.default_rng(seed).integers(len(altered)))
            altered[k] = [1.0, 0.0] if altered[k][0] < 0.5 else [0.0, 1.0]  # a confident answer for the other class
            readings = {
                "control_tf32": gate.score_numbers([(names, ctl)], names, ref_probs),
                "fault_answer_altered": gate.score_numbers([(names, altered)], names, ref_probs),
            }
    extras["reference_s"] = time.perf_counter() - t_ref
    correct, checks = gate.judge(numbers, cell.limits)

    ctx = SimpleNamespace(
        phase=phase,
        window_s=window_s,
        samples=calls * per_call,
        calls=calls,
        passes=[{**s, "kind": _pass_kind(s)} for s in stats],
        trace=summary,
        peak=peaks.peaks(torch.cuda.get_device_name(device) if device.type == "cuda" else "")[1],
        model=model,
        config=config,
        traffic=traffic,
        batch_info=model.batch_info(data_in, batch_size),
        memory_peak_bytes=memory_peak,
        setup_s=setup_s,
    )
    metrics = {}
    for metric in cell.per_layer if trace else cell.end_to_end:
        value = metric.reader.read(ctx, metric.phase)
        if value is not None:
            metrics[metric.name] = {"value": float(value), "unit": metric.unit}
    dev = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(memory_peak),
    }
    if summary is not None:
        dev.update({"busy_s": summary.busy_s, "window_s": summary.window_s})
    samples_per_pass = data_in.count
    result = {
        "correct": bool(correct),
        "attempted": int(ctx.samples),
        "failed": int(min(ctx.samples, nonfinite * samples_per_pass + (numbers.get("missing", 0) if phase == "score" else 0))),
        "metrics": metrics,
        "device": dev,
    }
    if summary is not None:
        result["breakdown"] = tracing.breakdown(summary)
    result["checks"] = checks
    extras.update({"calls": calls, "window_passes": window_passes, "numbers": numbers})
    if controls:
        extras["readings"] = readings
    shutil.rmtree(tmp, ignore_errors=True)
    return {"result": result, "extras": extras}
