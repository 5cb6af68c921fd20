"""Build and load the port's native libraries: the CUDA kernels
(``deeprank2_tpu_torch/csrc/*.cu``) and the featurization's host kernels
(``csrc/{sasa,pdb_parser,grid_kernels}.cpp``).

Each CUDA source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at its first use on a CUDA device (never at
import), and loaded with ``ctypes``. Each host source is compiled by ``g++``
at its first use (no CUDA needed), with the JAX package's flags, so both
packages compute the same bits on one machine. A library's name carries a
hash of the source and the flags (for a host library also the compiler's
version and the CPU's instruction-set flags and model, since
``-march=native`` code may not run on another host), so an edited source is
rebuilt and an unchanged one is loaded from the build directory
(``deeprank2_tpu_torch/_kernels/``, git-ignored).
Several sources build in parallel: one compiler each. A failed build or load
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# host sources and their extra flags: grid_kernels trades exact IEEE math
# for libmvec's vectorized exp (-ffast-math must be on the compile line to
# trigger it, and off the link line, or GCC < 13 links crtfastmath.o, whose
# constructor sets flush-to-zero for the whole process)
HOST_SOURCES = {"sasa": [], "pdb_parser": [], "grid_kernels": ["-ffast-math"]}
GXX_FLAGS = ["-O3", "-march=native", "-fPIC"]
_f64, _i32, _i64, _char = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_char)
# each host library's entry point: (name, argument types, return type)
_HOST_ENTRY = {
    "sasa": (
        "sasa_compute",
        [_f64, _f64, ctypes.c_int, _f64, ctypes.c_int, ctypes.c_double, _f64, _f64, _i64, ctypes.POINTER(ctypes.c_ubyte)],
        None,
    ),
    "pdb_parser": (
        "pdb_parse",
        [ctypes.c_char_p, _f64, _char, ctypes.POINTER(ctypes.c_int8), _f64, _i32, _i32, _char, _char, _i32, _char, _i64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64],
        ctypes.c_int64,
    ),
    "grid_kernels": (
        "gaussian_kernel_grid",
        [_f64, ctypes.c_int, _f64, ctypes.c_int, _f64, ctypes.c_int, _f64, ctypes.c_int, ctypes.c_double, ctypes.POINTER(ctypes.c_float)],
        None,
    ),
}

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


_host_identity: bytes | None = None


def _host() -> bytes:
    """``g++ --version`` and the CPU: its instruction-set flags and model
    name, what ``-march=native`` code depends on besides the source and the
    flags (the machine's architecture where the kernel lists neither)."""
    global _host_identity
    if _host_identity is None:
        try:
            version = subprocess.run(["g++", "--version"], capture_output=True, check=True, timeout=60).stdout
        except (OSError, subprocess.SubprocessError) as e:
            msg = f"g++ not usable ({e}); the host kernels cannot be built"
            raise RuntimeError(msg) from e
        cpu = {}
        try:
            with open("/proc/cpuinfo") as fh:
                for line in fh:
                    key, _, value = line.partition(":")
                    if key.strip() in ("flags", "Features", "model name") and key.strip() not in cpu:
                        cpu[key.strip()] = value.strip()
        except OSError:
            pass
        identity = "\n".join(cpu.get(k, "") for k in ("flags", "Features")) + "\n" + cpu.get("model name", platform.machine())
        _host_identity = version + identity.encode()
    return _host_identity


def host_target(name: str) -> Path:
    """The host library's path, named by a hash of ``csrc/{name}.cpp``, the
    flags, the compiler's version and the CPU (:func:`_host`)."""
    flags = " ".join([*GXX_FLAGS, *HOST_SOURCES[name]]).encode()
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes() + flags + _host())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_host(names: list[str] | None = None) -> dict[str, float]:
    """Compile every named host source (all by default) that has no
    up-to-date library, all at once; the seconds from the start until each
    library was linked."""
    names = list(HOST_SOURCES) if names is None else names
    pending = {n: host_target(n) for n in names if not host_target(n).exists()}
    if not pending:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start, seconds, failed = time.perf_counter(), {}, []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # compile to an object with the source's flags, then link without
        # them; publish under the final name by a rename, so a concurrent
        # loader (forked featurization workers) never sees a torn library
        compile_cmd = {n: ["g++", *GXX_FLAGS, *HOST_SOURCES[n], "-c", str(CSRC / f"{n}.cpp"), "-o", f"{tmp}/{n}.o"] for n in pending}
        steps = [compile_cmd, {n: ["g++", "-shared", "-o", f"{tmp}/{n}.so", f"{tmp}/{n}.o"] for n in pending}]
        for step in steps:
            procs = {}
            for name, cmd in step.items():
                try:
                    procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                except OSError as e:
                    failed.append(f"{name}.cpp: {e}")
            for name, proc in procs.items():
                log, _ = proc.communicate()
                build_logs[name] = build_logs.get(name, "") + log
                seconds[name] = time.perf_counter() - start
                if proc.returncode != 0:
                    failed.append(f"{name}.cpp (g++ exit {proc.returncode}):\n{log}")
            if failed:
                msg = "host kernel build failed:\n" + "\n".join(failed)
                raise RuntimeError(msg)
        for name, target in pending.items():
            os.replace(f"{tmp}/{name}.so", target)
    return seconds


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library built from ``csrc/{name}.cpp`` (built if
    needed); raises if it cannot be built or loaded."""
    lib = _loaded.get(f"{name}.cpp")
    if lib is None:
        build_host([name])
        try:
            lib = ctypes.CDLL(str(host_target(name)))
        except OSError as e:
            msg = f"cannot load the host kernel library {host_target(name)}: {e}"
            raise RuntimeError(msg) from e
        entry, argtypes, restype = _HOST_ENTRY[name]
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = restype
        _loaded[f"{name}.cpp"] = lib
    return lib
