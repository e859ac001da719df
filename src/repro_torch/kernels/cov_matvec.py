"""Centered-covariance matvec (one power-iteration step): CUDA kernel +
plain version.

Port of the reference's `kernels/cov_matvec.py` (one Pallas TPU kernel):
y = (X − μ)ᵀ((X − μ)w) for x (N, D) in f32 or bf16, f32 mean and w (D,).
The function exists twice here:

  * a hand-written CUDA kernel (`csrc/cov_matvec.cu`, two passes: per
    block partial sums, then a fixed-order reduction — no float atomics,
    so y is bitwise reproducible), launched by `cov_matvec_cuda`, which
    counts its device launches in `LAUNCHES`: two per call;
  * a plain PyTorch version (`cov_matvec_plain`) that repeats the
    kernel's order of sums with whole-tensor operations — row dot
    products in dimension order, each block's rows split into `groups`
    strided sequences, a halving tree over the groups, then the
    cross-block reduction — so the two agree bitwise.

`kernels/ops.py` picks one by the tensors' device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib

# device launches since the last reset, two per call (pass 1 and pass 2;
# never counted by the plain version)
LAUNCHES = {"cov_matvec": 0}

_THREADS = 256          # threads per block and rows per tile (csrc/cov_matvec.cu)
_TARGET_BLOCKS = 256    # pass 1 launches at most this many blocks
# pass 1's shared memory, (256 + groups·D) floats, stays under 48 KB
_MAX_D = 48 * 1024 // 4 - _THREADS


def geometry(n: int, d: int):
    """(rows_per_block, blocks, groups) of pass 1 — a function of the
    shape alone, so the sum order (and y) never depends on the card."""
    tile = _THREADS * _TARGET_BLOCKS
    rows_per_block = _THREADS * max(1, -(-n // tile))
    blocks = -(-n // rows_per_block)
    groups = 1 << ((_THREADS // min(d, _THREADS)).bit_length() - 1)
    return rows_per_block, blocks, groups


def block_plan(n: int, d: int, itemsize: int = 4) -> dict:
    """Cost of one call as the CUDA kernel runs it: `blocks` is what it
    launches (pass 1's row blocks + pass 2's one block per column);
    `flops` is the function's arithmetic, two matvecs over the centered
    rows (4ND); `hbm_bytes` is what the function must move — x read once
    at its width, mean and w read once and y written once in f32."""
    _, blocks, _ = geometry(n, d)
    return {
        "blocks": blocks + d,
        "flops": 4 * n * d,
        "hbm_bytes": n * d * itemsize + 12 * d,
    }


def _halve(acc: torch.Tensor, width: int, dim: int) -> torch.Tensor:
    """The kernels' halving tree over `width` (a power of two) entries
    of `dim`: a[i] += a[i + s] for s = width/2, ..., 1; returns a[0]."""
    s = width // 2
    while s >= 1:
        acc = acc.narrow(dim, 0, s) + acc.narrow(dim, s, s)
        s //= 2
    return acc.select(dim, 0)


def cov_matvec_plain(x: torch.Tensor, mean: torch.Tensor, w: torch.Tensor):
    """Plain version: x (N, D) f32 / bf16, mean and w (D,) f32 -> (D,) f32."""
    n, d = x.shape
    if n == 0:
        return torch.zeros(d, dtype=torch.float32, device=x.device)
    xc = x.to(torch.float32) - mean[None, :]
    t = torch.zeros(n, dtype=torch.float32, device=x.device)
    for k in range(d):
        t = t + xc[:, k] * w[k]
    prod = t[:, None] * xc
    rows, blocks, groups = geometry(n, d)
    prod = F.pad(prod, (0, 0, 0, blocks * rows - n))  # zero rows add nothing
    prod = prod.reshape(blocks, rows // groups, groups, d)
    acc = torch.zeros((blocks, groups, d), dtype=torch.float32, device=x.device)
    for m in range(rows // groups):  # group g: rows g, g + groups, ... in order
        acc = acc + prod[:, m]
    partial = _halve(acc, groups, 1)                      # (blocks, d)
    chunks = -(-blocks // _THREADS)
    partial = F.pad(partial, (0, 0, 0, chunks * _THREADS - blocks))
    partial = partial.reshape(chunks, _THREADS, d)
    v = torch.zeros((_THREADS, d), dtype=torch.float32, device=x.device)
    for c in range(chunks):  # thread j: blocks j, j + 256, ... in order
        v = v + partial[c]
    return _halve(v, _THREADS, 0)


def cov_matvec_cuda(x: torch.Tensor, mean: torch.Tensor, w: torch.Tensor):
    """Launch the kernel (same contract as `cov_matvec_plain`)."""
    code = {torch.float32: 0, torch.bfloat16: 1}.get(x.dtype)
    if code is None or x.dim() != 2:
        raise ValueError(f"cov_matvec: x must be (N, D) f32 or bf16, got {x.dtype}")
    n, d = x.shape
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"cov_matvec: D={d} outside [1, {_MAX_D}]")
    for name, t in (("x", x), ("mean", mean), ("w", w)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"cov_matvec: {name} must be contiguous on {x.device}")
    for name, t in (("mean", mean), ("w", w)):
        if t.dtype != torch.float32 or tuple(t.shape) != (d,):
            raise ValueError(f"cov_matvec: {name} must be f32 ({d},)")
    y = torch.zeros(d, dtype=torch.float32, device=x.device)
    if n == 0:
        return y
    rows, blocks, groups = geometry(n, d)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    lib = cuda_lib.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cov_matvec_launch(
            code, x.data_ptr(), mean.data_ptr(), w.data_ptr(), n, d, rows,
            groups, partial.data_ptr(), y.data_ptr(), stream,
        )
    cuda_lib.raise_on(err, "cov_matvec")
    LAUNCHES["cov_matvec"] += 2  # cov_partial_kernel, then cov_reduce_kernel
    return y
