"""ctypes bindings for the native batch assembler, ``native/tecloader.cpp``.

The source is framework-free host C++ at the repository root: multithreaded
``memcpy`` of each window's contiguous (N, C) timestep rows (its in-place
standardization is not bound: nothing in the port calls it). It is built with ``g++ -O3 -shared -fPIC`` at first use into
``build/tec_mollm_tpu_torch/native-<hash of the source>/`` (beside the CUDA
library of ``ops/_build.py``), never next to the source, and loaded once per
process. ``available()`` says whether that worked; ``SlidingWindowDataset``
then gathers through it and otherwise uses numpy (and logs why).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "tecloader.cpp"
BUILD_ROOT = _ROOT / "build" / "tec_mollm_tpu_torch"
LIB_NAME = "libtecloader.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed: str | None = None


def _build() -> Path:
    """The library for the current source, compiled if it is not there yet.
    Compiles to a temporary name and renames, so processes that build at once
    never load a half-written file."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out_dir = BUILD_ROOT / f"native-{digest}"
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".tecloader-", suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(SOURCE), "-lpthread"]
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    logger.info("built %s", lib_path)
    return lib_path


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.tec_gather_windows.restype = ctypes.c_int
    lib.tec_gather_windows.argtypes = [
        ctypes.POINTER(ctypes.c_float),   # X
        ctypes.POINTER(ctypes.c_float),   # Y
        ctypes.POINTER(ctypes.c_int32),   # TF
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # T, N, C
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # L_out, F_t, L_in
        ctypes.POINTER(ctypes.c_int64),   # starts
        ctypes.c_int64, ctypes.c_int64,   # batch, num_threads
        ctypes.POINTER(ctypes.c_float),   # x_out
        ctypes.POINTER(ctypes.c_float),   # y_out
        ctypes.POINTER(ctypes.c_int32),   # tf_out
    ]
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, or None when it cannot be built or loaded here (the
    reason is logged once)."""
    global _lib, _failed
    with _lock:
        if _lib is None and _failed is None:
            try:
                _lib = _load(_build())
            except (OSError, subprocess.SubprocessError) as e:
                detail = getattr(e, "stderr", None) or e
                _failed = str(detail).strip()[-500:]
                logger.info("native window gather unavailable (%s); numpy gathers instead", _failed)
        return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _threads(limit: int) -> int:
    return min(os.cpu_count() or 1, limit)


def gather_windows(
    X: np.ndarray,          # (T, N, C) float32, C-contiguous
    Y: np.ndarray,          # (T, N, L_out) float32
    TF: np.ndarray,         # (T, F_t) int32
    starts: np.ndarray,     # (B,) window start indices
    L_in: int,
    num_threads: int | None = None,
) -> dict[str, np.ndarray]:
    """x = X[s : s+L_in], y = Y[s + L_in - 1], time_features = TF[s : s+L_in]
    for each start s: the numpy gather's arrays, bit for bit."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native window gather is unavailable: {_failed}")
    # the C side reads raw pointers: refuse what it would misread
    for name, arr, dt in (("X", X, np.float32), ("Y", Y, np.float32), ("TF", TF, np.int32)):
        if not arr.flags.c_contiguous or arr.dtype != dt:
            raise ValueError(
                f"{name} must be C-contiguous {np.dtype(dt).name}, got "
                f"dtype={arr.dtype} contiguous={arr.flags.c_contiguous}"
            )
    t, n, c = X.shape
    l_out, f_t = Y.shape[-1], TF.shape[-1]
    if Y.shape[:2] != (t, n) or TF.shape[0] != t:
        raise ValueError(f"X {X.shape}, Y {Y.shape} and TF {TF.shape} disagree")
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    if len(starts) and (starts.min() < 0 or starts.max() + L_in > t):
        raise ValueError(f"window starts must lie in [0, {t - L_in}]")
    b = len(starts)
    x_out = np.empty((b, L_in, n, c), dtype=np.float32)
    y_out = np.empty((b, n, l_out), dtype=np.float32)
    tf_out = np.empty((b, L_in, f_t), dtype=np.int32)
    rc = lib.tec_gather_windows(
        _ptr(X, ctypes.c_float), _ptr(Y, ctypes.c_float), _ptr(TF, ctypes.c_int32),
        t, n, c, l_out, f_t, L_in,
        _ptr(starts, ctypes.c_int64), b, num_threads or _threads(8),
        _ptr(x_out, ctypes.c_float), _ptr(y_out, ctypes.c_float), _ptr(tf_out, ctypes.c_int32),
    )
    if rc != 0:
        raise RuntimeError(f"tec_gather_windows failed with code {rc}")
    return {"x": x_out, "y": y_out, "time_features": tf_out}

