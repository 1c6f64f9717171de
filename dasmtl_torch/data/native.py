"""ctypes bindings for the port's native MAT reader (``csrc/dasmat.cpp``).

Counterpart of ``dasmtl/data/native.py``: a GIL-free MAT-5 parser plus a
multithreaded batch loader that fills a preallocated [N, H, W] float32
buffer, in place of ``scipy.io.loadmat`` one file at a time.

- The library is built with ``g++`` on first use (never at import) into
  ``build/dasmtl_torch/`` beside the package, named by a hash of the
  source, and apart from the CUDA kernel library: a host with no ``nvcc``
  builds it.
- ``configure(mode)`` selects the reader per ``Config.loader_native``:
  ``auto`` uses the library when it builds and loads and otherwise reads
  with scipy (the JAX package's documented fallback for a host parser),
  ``off`` forces scipy, ``on`` raises at ``configure`` when the library
  does not build or load.
- JAX's install-time extension (``_packaged_lib``) is not carried: the
  port builds on demand.  A plain lock stands where JAX uses a lockdep
  lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from dasmtl_torch.ops._build import BUILD_DIR

_ERROR_NAMES = {
    0: "OK", 1: "EIO (cannot read file)", 2: "EFORMAT (MAT-5 parse error)",
    3: "ENOTFOUND (key not present)", 4: "ESHAPE (dims mismatch)",
    5: "EUNSUPPORTED (outside supported MAT subset)",
    6: "EZLIB (decompression failure)",
}

_SRC = str(Path(__file__).resolve().parent.parent / "csrc" / "dasmat.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_mode = "auto"  # auto | on | off — Config.loader_native, via configure()


def configure(mode: str) -> None:
    """Select the reader: ``auto`` uses the native library when it loads,
    ``off`` forces scipy, and ``on`` requires the native path (a startup
    error beats silently training at scipy speed)."""
    global _mode
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"loader_native must be auto|on|off, got {mode!r}")
    _mode = mode
    if mode == "on" and _load() is None:
        raise RuntimeError(
            "loader_native='on' but the native MAT reader did not "
            "build/load (check g++/zlib, or the packaged dasmtl.data."
            "_dasmat extension) — use loader_native=auto for the "
            "transparent scipy fallback")


def library_path() -> Optional[Path]:
    """Where the library for this source lives (None when the source
    cannot be read)."""
    try:
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS)
                                    .encode()).hexdigest()[:16]
    except OSError:
        return None
    return BUILD_DIR / f"libdasmat-{digest}.so"


def _build() -> Optional[str]:
    """Compile the shared library unless it is on disk; None on failure."""
    lib_path = library_path()
    if lib_path is None:
        return None
    if lib_path.exists():
        return str(lib_path)
    tmp = f"{lib_path}.tmp{os.getpid()}-{threading.get_ident()}"
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, _SRC, "-lz", "-pthread"]
    try:
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)  # atomic: a concurrent loader never
        return str(lib_path)       # sees half a library
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _build()
        if path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.das_mat_dims.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.das_mat_dims.restype = ctypes.c_int
            lib.das_load_mat_f32.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
            lib.das_load_mat_f32.restype = ctypes.c_int
            lib.das_load_many_f32.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int)]
            lib.das_load_many_f32.restype = ctypes.c_int
        except (OSError, AttributeError):
            # A library that does not load (wrong arch or libc, no libz) or
            # lacks a symbol: read with scipy instead.
            _build_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library loaded and the mode allows it."""
    if _mode == "off":
        return False
    return _load() is not None


def status() -> str:
    """``loaded``, ``build-failed`` or ``not-loaded`` (no build tried)."""
    if _lib is not None:
        return "loaded"
    return "build-failed" if _build_failed else "not-loaded"


class NativeMatError(RuntimeError):
    def __init__(self, code: int, context: str):
        super().__init__(
            f"{context}: {_ERROR_NAMES.get(code, f'error {code}')}")
        self.code = code


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise NativeMatError(-1, "native library unavailable")
    return lib


def mat_dims(path: str, key: str = "data") -> tuple:
    lib = _require()
    rows, cols = ctypes.c_int(), ctypes.c_int()
    rc = lib.das_mat_dims(path.encode(), key.encode(),
                          ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise NativeMatError(rc, path)
    return rows.value, cols.value


def load_mat_f32(path: str, key: str = "data",
                 shape: Optional[tuple] = None) -> np.ndarray:
    """One variable as row-major float32."""
    lib = _require()
    rows, cols = shape if shape is not None else mat_dims(path, key)
    out = np.empty((rows, cols), np.float32)
    rc = lib.das_load_mat_f32(
        path.encode(), key.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols)
    if rc != 0:
        raise NativeMatError(rc, path)
    return out


def load_many_f32(paths: Sequence[str], key: str, rows: int, cols: int,
                  n_threads: Optional[int] = None,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    """``len(paths)`` same-shaped arrays into a [N, rows, cols] float32
    buffer (``out`` when given, C-contiguous), read in parallel with the
    GIL released."""
    lib = _require()
    n = len(paths)
    if out is None:
        out = np.empty((n, rows, cols), np.float32)
    elif (out.shape != (n, rows, cols) or out.dtype != np.float32
          or not out.flags.c_contiguous):
        raise NativeMatError(4, f"out buffer {out.shape} {out.dtype} for "
                                f"{n} x {rows} x {cols} float32")
    if n == 0:
        return out
    if n_threads is None:
        n_threads = min(n, os.cpu_count() or 1)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    fail = ctypes.c_int(-1)
    rc = lib.das_load_many_f32(
        arr, n, key.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols,
        n_threads, ctypes.byref(fail))
    if rc != 0:
        raise NativeMatError(rc, paths[fail.value] if fail.value >= 0
                             else "<batch>")
    return out
