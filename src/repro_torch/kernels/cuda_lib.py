"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

The sources have a plain C interface, so they are compiled by `nvcc` into
one shared library and bound with ctypes — no PyTorch headers, a build of
seconds. The build happens at first use, into
``<repo>/build/repro_torch/<hash of the sources>/`` (listed in
`.gitignore`; `REPRO_TORCH_BUILD_DIR` overrides the root), so a changed
source never loads a stale library. Nothing here runs at import time:
the CPU tests import every module on a machine with no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SOURCES = ("topk_l2.cu",)
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_LOCK = threading.Lock()
_LIB = None
# what the last build did: seconds, path, nvcc's -Xptxas -v report
BUILD_INFO: dict = {}


def _build_root() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return _CSRC.parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(_ARCH.encode())
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return _build_root() / _digest() / "librepro_torch_kernels.so"


def build() -> pathlib.Path:
    """Compile the sources unless a library for their hash exists."""
    out = library_path()
    if out.exists():
        BUILD_INFO.update(seconds=0.0, path=str(out), cached=True)
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), _ARCH, "-std=c++17", "-O3", "-fmad=false", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
        *[str(_CSRC / s) for s in _SOURCES],
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    BUILD_INFO.update(
        seconds=time.perf_counter() - t0,
        path=str(out),
        cached=False,
        ptxas=proc.stderr,
    )
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.leaf_topk_launch.argtypes = [
                i, p, p, p, p, p, i, i, i, i, p, p, p, p
            ]
            lib.leaf_topk_launch.restype = i
            lib.topk_l2_launch.argtypes = [
                p, p, p, p, i, i, i, i, i, p, p, p, p
            ]
            lib.topk_l2_launch.restype = i
            _LIB = lib
        return _LIB
