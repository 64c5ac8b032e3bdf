"""Build, load and count the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and the objects are linked into one shared library with
a plain C interface, which ``ctypes`` loads. The library lands in
``build/tec_mollm_tpu_torch/<hash of the sources>/`` at the repository root and is
rebuilt when the sources change. The build happens at the first kernel launch,
never at import: the CPU tests import every module on a machine without ``nvcc``.

Each C entry point returns ``cudaGetLastError()`` after its launches; the
wrappers raise when that is not 0. A failed build raises too: there is no
fallback to the plain PyTorch version for a CUDA tensor.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "tec_mollm_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libtec_mollm_kernels.so"
# the namespace of the forward kernels' registered ops (torch.ops.tec_mollm.*)
NAMESPACE = "tec_mollm"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_functions: dict[str, ctypes._CFuncPtr] = {}

# Launches per kernel since the last reset_counts(): each wrapper adds one where
# it launches its kernel and nowhere else.
_counts: collections.Counter = collections.Counter()
_counts_lock = threading.Lock()


def count_launch(name: str) -> None:
    with _counts_lock:
        _counts[name] += 1


def launch_counts() -> dict[str, int]:
    with _counts_lock:
        return dict(_counts)


def reset_counts() -> None:
    with _counts_lock:
        _counts.clear()


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the sources (in parallel) and link the library; return its path."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (out_dir / "ptxas.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS[:2], "-shared", *(str(o) for _, o, _ in procs),
         "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name`` with its argument types declared (pointers and
    the stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    with _lock:
        fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        with _lock:
            _functions[name] = fn
    return fn


def refuse_grad(name: str, hint: str, *tensors) -> None:
    """A launch fills its outputs outside autograd: raise when grad mode is on
    and an input requires grad, so that no output silently lacks a gradient."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: {hint}")


def op_for(op, impl, t):
    """The registered ``op``, or for a meta tensor its implementation
    ``impl``, whose launch raises: the op's shape function would answer for
    a meta tensor, and a tensor off the CPU goes to the kernel or raises."""
    return impl if t.device.type == "meta" else op


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
