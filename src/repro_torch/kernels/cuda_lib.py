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

import contextlib
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
# zeroed uint32 ticket counters per (device index, stream handle); the
# kernels that find their last block with them leave them at 0 again
_TICKETS: dict = {}
# counters a stream's buffer holds: topk_l2 takes one per query group when
# it splits the arena, which it does only for fewer than 264 groups
# (`topk_l2.scan_geometry`); cov_matvec takes one
TICKETS = 264
_SAME_DEVICE = contextlib.nullcontext()
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
        # -lcuda: libcuda's tensor-map encoder (TMA) in pairwise_l2.cu
        _run_all([[_nvcc(), _ARCH, "-shared", "-o", str(tmp), *map(str, objs),
                   "-lcuda"]])
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


def ticket_counters(index: int, stream: int, n: int):
    """A tensor of `TICKETS` zeroed uint32 ticket counters (int32 storage)
    for launches on `stream` (a CUDA stream handle) on device `index`;
    raises if `n` > `TICKETS`. A kernel that finds its last block by an
    atomic ticket resets its counter to 0 before it ends, so the buffer is
    zeroed once, when it is made, and shared by every later launch on that
    stream: launches on one stream run in order, and each stream has its
    own buffer, which is kept for good (never replaced or freed).

    CUDA graphs: a launch captured while its stream's buffer exists uses
    that buffer, so its graph must be replayed on the capture stream (or
    never alongside other launches on that stream). Where the buffer does
    not exist yet, it is made inside the capture (its zeroing replays with
    the graph) and not kept: the graph owns it."""
    import torch

    if n > TICKETS:
        raise ValueError(f"{n} ticket counters asked for, a stream has {TICKETS}")
    key = (index, stream)
    buf = _TICKETS.get(key)
    if buf is not None:
        return buf
    with _LOCK:
        buf = _TICKETS.get(key)
        if buf is None:
            buf = torch.zeros(TICKETS, dtype=torch.int32,
                              device=torch.device("cuda", index))
            if not torch.cuda.is_current_stream_capturing():
                _TICKETS[key] = buf
        return buf


def on_device(index: int):
    """A context that makes device `index` the current one for a launch
    (the kernels launch on the runtime's current device): nothing to do
    where it is current already, which saves the device switch's host
    cost on every call."""
    import torch

    if index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(index)


def current_stream(index: int) -> int:
    """The handle of device `index`'s current CUDA stream — the one
    `torch.cuda.current_stream(index).cuda_stream` names, without making a
    Stream object (a few microseconds a call on the host)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)


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
                p, p, p, p, i, i, i, i, i, i, p, p, p, p, p, p, p, p, p
            ]
            lib.topk_l2_launch.restype = i
            lib.leaf_topk_sort_launch.argtypes = [
                i, p, p, p, p, p, i, i, i, i, i, p, p, p, p, p
            ]
            lib.leaf_topk_sort_launch.restype = i
            lib.topk_l2_sort_launch.argtypes = [
                p, p, p, p, i, i, i, i, i, p, p, p, p, p
            ]
            lib.topk_l2_sort_launch.restype = i
            lib.pairwise_sq_l2_launch.argtypes = [i, i, p, p, i, i, i, p, p, p]
            lib.pairwise_sq_l2_launch.restype = i
            lib.pairwise_sq_l2_scratch_bytes.argtypes = [i, i, i, i, i]
            lib.pairwise_sq_l2_scratch_bytes.restype = ctypes.c_longlong
            lib.pairwise_sq_l2_wide_min_d.argtypes = []
            lib.pairwise_sq_l2_wide_min_d.restype = i
            q = ctypes.c_longlong
            lib.cov_matvec_launch.argtypes = [i, p, p, p, q, i, i, q, i, p, p, p, p]
            lib.cov_matvec_launch.restype = i
            _LIB = lib
        return _LIB
