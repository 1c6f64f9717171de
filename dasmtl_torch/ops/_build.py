"""Build and load the port's hand-written CUDA kernels.

Route (b) of the Hopper kernel notes: ``nvcc`` compiles every
``dasmtl_torch/csrc/*.cu`` (one process per source, all started together;
the ``*.cuh`` headers they include are hashed with them)
for ``sm_90a`` and links them into ONE shared library with a plain C
interface, loaded with :mod:`ctypes`.  That builds in seconds, where a
``torch.utils.cpp_extension`` build that includes PyTorch's headers takes
minutes.

- The library lands in ``build/dasmtl_torch/`` beside the package, named
  by a hash of the sources and flags, so a second run reuses it.
- Nothing is built at import and nothing is built for the CPU: the first
  CUDA call of a kernel wrapper calls :func:`library`.
- A failed build raises :class:`BuildError` carrying nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dasmtl_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
#: C entry points: name -> (restype, argtypes).  Every pointer and the
#: stream are ``c_void_p`` (a bare int would be cut to 32 bits).
SIGNATURES = {
    "dasmtl_gate_fwd": (ctypes.c_int, [ctypes.c_int, _P, _P, _P, _P, _P,
                                       ctypes.c_int64, _P]),
    "dasmtl_gate_bwd": (ctypes.c_int, [_P, _P, _P, _P, _P, ctypes.c_int64,
                                       _P]),
    "dasmtl_decode_heads": (ctypes.c_int, [
        _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int64,
        _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P]),
    "dasmtl_event_prob_q": (ctypes.c_int, [
        _P, ctypes.c_int, ctypes.c_int64, _P, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _P]),
    "dasmtl_window_gather": (ctypes.c_int, [
        _P, ctypes.c_int64, ctypes.c_int64, _P, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P]),
    "dasmtl_ring_append": (ctypes.c_int, [
        _P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _P, _P]),
    "dasmtl_int8_dot": (ctypes.c_int, [_P, _P, _P, _P, _P, ctypes.c_int64,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, _P]),
    "dasmtl_leaf_digest": (ctypes.c_int, [_P, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, _P, ctypes.c_int,
                                          _P]),
    "dasmtl_leaf_digest_blocks_per_sm": (ctypes.c_int, [_P]),
    "dasmtl_batch_gather": (ctypes.c_int, [
        _P, _P, _P, ctypes.c_int64, ctypes.c_int64, _P, _P, ctypes.c_int,
        _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _P]),
    "dasmtl_fold_select": (ctypes.c_int, [
        _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
        ctypes.c_int64, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]),
    "dasmtl_fold_select_blocks_per_sm": (ctypes.c_int, [_P]),
    "dasmtl_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


class BuildError(RuntimeError):
    """nvcc could not be found or refused the sources."""


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: nvcc builds this process ran, and CUDA graphs it captured: the port's
#: run-time compiles, which the step guards count (eager PyTorch compiles
#: nothing per shape; a graph capture is the counterpart of an XLA
#: compile of a scan program).
_compiles = 0
_captures = 0
#: nvcc's ``-Xptxas -v`` report and the build seconds of the last build
#: this process ran (empty / 0.0 when the library was already on disk).
build_log = ""
build_seconds = 0.0


def compiles() -> int:
    """How many kernel-library builds and CUDA-graph captures this process
    has run."""
    return _compiles + _captures


def note_capture() -> None:
    """Count one CUDA-graph capture as a run-time compile."""
    global _captures
    with _lock:
        _captures += 1


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdasmtl_torch_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise BuildError(f"nvcc not found on PATH or at {default}; the "
                     f"dasmtl_torch kernels are built on first CUDA use")


def build() -> Path:
    """Compile the library unless it is already on disk; its path."""
    global build_log, build_seconds, _compiles
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp-{os.getpid()}-{threading.get_ident()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        procs = []
        for src in _sources():
            obj = work / f"{src.stem}.o"
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            stdout, stderr = proc.communicate()
            logs.append(f"== {src.name}\n{stdout}{stderr}")
            if proc.returncode:
                failed.append(f"nvcc failed on {src.name} "
                              f"(exit {proc.returncode}):\n{stderr}")
        if failed:
            raise BuildError("\n".join(failed))
        tmp = work / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
            capture_output=True, text=True)
        if link.returncode:
            raise BuildError(f"nvcc link failed (exit {link.returncode}):\n"
                             f"{link.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    _compiles += 1
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def check_launch(rc: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc:
        msg = library().dasmtl_error_string(rc).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} ({msg})")
