"""Blocked squared-L2 distance matrix: CUDA kernel + plain version.

Port of the reference's `kernels/pairwise_l2.py` (one Pallas TPU kernel)
and its oracle. The function exists twice here:

  * a hand-written CUDA kernel (`csrc/pairwise_l2.cu`), launched by
    `pairwise_cuda`, which counts its launches in `LAUNCHES`;
  * a plain PyTorch version (`pairwise_plain`) that repeats the kernel's
    arithmetic operation by operation — the expansion form
    (|q|² + |p|²) − 2·q·p, every dot product summed in dimension order
    with separately rounded operations, clamped at 0, exactly the
    `topk_l2` kernel's `expansion_sq` — so the two agree bitwise.

`kernels/ops.py` picks one by the tensors' device.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .topk_l2 import expansion_sq

# kernel launches since the last reset (never counted by the plain version)
LAUNCHES = {"pairwise_sq_l2": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64            # output rows and columns per block (csrc/pairwise_l2.cu)
_MAX_ROW_TILES = 65535  # the grid's y extent


def _tiles(x: int) -> int:
    return (x + _TILE - 1) // _TILE


def block_plan(m: int, n: int, d: int, itemsize: int = 4) -> dict:
    """Cost of one launch as the CUDA kernel runs it: `grid` and
    `blocks` are what it launches (one 64×64 output tile per block);
    `flops` is the function's arithmetic — the (M, N, D) product and
    the two norm sums; `hbm_bytes` is what the function must move — q
    and p read once at their width, the (M, N) f32 matrix written
    once."""
    grid = (_tiles(n), _tiles(m))
    return {
        "grid": grid,
        "blocks": grid[0] * grid[1],
        "flops": 2 * m * n * d + 2 * (m + n) * d,
        "hbm_bytes": (m + n) * d * itemsize + 4 * m * n,
    }


def pairwise_plain(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain version: q (M, D), p (N, D) in f32 or bf16 -> (M, N) f32."""
    return expansion_sq(q.to(torch.float32), p.to(torch.float32))


def pairwise_cuda(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Launch the kernel (same contract as `pairwise_plain`); q and p
    share one dtype, f32 or bf16, widened in the kernel's registers."""
    code = _DTYPE_CODES.get(q.dtype)
    if code is None or p.dtype != q.dtype:
        raise ValueError(
            f"pairwise_sq_l2: needs f32 or bf16 alike, got {q.dtype}, {p.dtype}"
        )
    if q.device != p.device or q.dim() != 2 or p.dim() != 2:
        raise ValueError("pairwise_sq_l2: q (M, D), p (N, D) on one device")
    if not (q.is_contiguous() and p.is_contiguous()):
        raise ValueError("pairwise_sq_l2: q and p must be contiguous")
    m, d = q.shape
    n = p.shape[0]
    if p.shape[1] != d:
        raise ValueError(f"pairwise_sq_l2: {tuple(q.shape)} vs {tuple(p.shape)}")
    if _tiles(m) > _MAX_ROW_TILES:
        raise ValueError(f"pairwise_sq_l2: M={m} exceeds the grid")
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    if m == 0 or n == 0:
        return out
    lib = cuda_lib.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pairwise_sq_l2_launch(
            code, q.data_ptr(), p.data_ptr(), m, n, d, out.data_ptr(), stream
        )
    cuda_lib.raise_on(err, "pairwise_sq_l2")
    LAUNCHES["pairwise_sq_l2"] += 1
    return out
