"""Build and load the port's CUDA kernels (``deeprank2_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at its first use on a CUDA device (never at
import), and loaded with ``ctypes``. The library's name carries a hash of
the source and the flags, so an edited source is rebuilt and an unchanged one
is loaded from the build directory (``deeprank2_tpu_torch/_kernels/``,
git-ignored). Several sources build in parallel: one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # nvcc output (ptxas register/shared-memory report) of each build in this process


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        msg = "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA kernels cannot be built"
        raise RuntimeError(msg)
    return found


def _target(name: str) -> Path:
    """The library's path, named by a hash of the source, the local headers
    it includes (``#include "x.cuh"`` from ``csrc/``, and theirs in turn)
    and the flags."""
    texts, pending = {}, [f"{name}.cu"]
    while pending:
        file = pending.pop()
        if file not in texts:
            texts[file] = (CSRC / file).read_bytes()
            pending += [h.decode() for h in re.findall(rb'^#include "([^"]+)"', texts[file], flags=re.MULTILINE)]
    digest = hashlib.sha256(b"".join(texts[f] for f in sorted(texts)) + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> None:
    """Compile every named source that has no up-to-date library, all at once."""
    pending = {n: _target(n) for n in names if not _target(n).exists()}
    if not pending:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, target in pending.items():
        # build under a temporary name and rename, so a concurrent loader never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/{name}.cu`` (built if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = f"{what} failed: CUDA error {code} ({lib.cuda_error_string(code).decode()})"
        raise RuntimeError(msg)
