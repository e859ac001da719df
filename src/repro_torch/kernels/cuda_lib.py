"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

The sources have a plain C interface, so they are compiled by `nvcc` into
one shared library and bound with ctypes — no PyTorch headers, a build of
seconds: one `nvcc` per source, all started together, then one link. The
build happens at first use, into
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
_SOURCES = ("topk_l2.cu", "pairwise_l2.cu", "cov_matvec.cu")
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


def _run_all(cmds):
    """Run the commands concurrently; raise on the first that failed."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for c in cmds
    ]
    outs = [p.communicate() for p in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}"
            )
    return "".join(err for _, err in outs)


def build() -> pathlib.Path:
    """Compile the sources unless a library for their hash exists."""
    out = library_path()
    if out.exists():
        BUILD_INFO.update(seconds=0.0, path=str(out), cached=True)
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [out.parent / f"{pathlib.Path(s).stem}.{tag}.o" for s in _SOURCES]
    flags = [_ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]
    t0 = time.perf_counter()
    try:
        ptxas = _run_all([
            [_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", str(o), str(_CSRC / s)]
            for s, o in zip(_SOURCES, objs)
        ])
        tmp = out.with_suffix(f".{tag}")
        _run_all([[_nvcc(), _ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    BUILD_INFO.update(
        seconds=time.perf_counter() - t0,
        path=str(out),
        cached=False,
        ptxas=ptxas,
    )
    return out


def raise_on(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error (0 = launched)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


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
            lib.pairwise_sq_l2_launch.argtypes = [i, p, p, i, i, i, p, p]
            lib.pairwise_sq_l2_launch.restype = i
            lib.cov_matvec_launch.argtypes = [i, p, p, p, i, i, i, i, p, p, p]
            lib.cov_matvec_launch.restype = i
            _LIB = lib
        return _LIB
