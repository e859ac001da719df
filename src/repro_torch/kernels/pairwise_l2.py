"""Blocked squared-L2 distance matrix: CUDA kernel + plain version.

Port of the reference's `kernels/pairwise_l2.py` (one Pallas TPU kernel)
and its oracle. The function exists twice here:

  * a hand-written CUDA kernel (`csrc/pairwise_l2.cu`), launched by
    `pairwise_cuda`, which counts its launches in `LAUNCHES`. It has two
    routes, chosen by D alone (`route`): below `WIDE_MIN_D` the
    "cuda_core" route repeats the plain version's arithmetic operation
    by operation, so the two agree bitwise; from `WIDE_MIN_D` on the
    cross term runs on the tensor cores ("wgmma_bf16" for bf16
    operands, "wgmma_tf32x3" — three TF32 products per term — for f32),
    with the plain version's norms, and agrees with it within the
    expansion-form tolerance 8·2⁻²⁴·(max|q|² + max|p|²);
  * a plain PyTorch version (`pairwise_plain`): the expansion form
    (|q|² + |p|²) − 2·q·p, every dot product summed in dimension order
    with separately rounded operations, clamped at 0, exactly the
    `topk_l2` kernel's `expansion_sq`.

`kernels/ops.py` picks one by the tensors' device.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .topk_l2 import expansion_sq

# kernel launches since the last reset (never counted by the plain version)
LAUNCHES = {"pairwise_sq_l2": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODES = {"cuda_core": 0, "wgmma_bf16": 1, "wgmma_tf32x3": 1}
# D from which the tensor-core route runs (kWideMinD in csrc/pairwise_l2.cu)
WIDE_MIN_D = 14
# the largest D the cuda_core kernel is built for (kNarrowMaxD): a caller
# may force that route up to here, as the route-threshold measurement does
NARROW_MAX_D = 15
# (rows, columns) of the output tile of one block, per route
_TILES = {"cuda_core": (64, 256), "wgmma_bf16": (128, 128),
          "wgmma_tf32x3": (128, 128)}
_MAX_BLOCKS = 2**31 - 1  # the grid's x extent


def route(d: int, itemsize: int = 4) -> str:
    """The route the kernel takes for depth `d` and operand width
    `itemsize` (4 = f32, 2 = bf16)."""
    if d < WIDE_MIN_D:
        return "cuda_core"
    return "wgmma_bf16" if itemsize == 2 else "wgmma_tf32x3"


def _blocks(m: int, n: int, name: str) -> int:
    tm, tn = _TILES[name]
    return -(-m // tm) * -(-n // tn)


def block_plan(m: int, n: int, d: int, itemsize: int = 4) -> dict:
    """Cost of one call as the CUDA kernels run it: `route`, and `grid`,
    the blocks of each launch — the cuda_core route one launch of one
    `tile` of the output per block; the wgmma routes a norm pass (one
    row of [q; p] per thread, 256 per block), then the product over
    `tile`s, which at most one persistent block per SM walks in turn
    (`blocks` counts the tiles). `flops` is the function's arithmetic —
    the (M, N, D) product and the two norm sums; `hbm_bytes` is what
    the function must move — q and p read once at their width, the
    (M, N) f32 matrix written once."""
    name = route(d, itemsize)
    tiles = _blocks(m, n, name)
    grid = (tiles,) if name == "cuda_core" else (-(-(m + n) // 256), tiles)
    return {
        "route": name,
        "tile": _TILES[name],
        "grid": grid,
        "blocks": sum(grid),
        "flops": 2 * m * n * d + 2 * (m + n) * d,
        "hbm_bytes": (m + n) * d * itemsize + 4 * m * n,
    }


def pairwise_plain(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Plain version: q (M, D), p (N, D) in f32 or bf16 -> (M, N) f32."""
    return expansion_sq(q.to(torch.float32), p.to(torch.float32))


def pairwise_cuda(q: torch.Tensor, p: torch.Tensor, *,
                  route_name: str | None = None) -> torch.Tensor:
    """Launch the kernel (same contract as `pairwise_plain`); q and p
    share one dtype, f32 or bf16. `route_name` forces a route (the
    route-threshold measurement does); by default D chooses it."""
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
    name = route_name or route(d, q.element_size())
    if name not in ("cuda_core", route(WIDE_MIN_D, q.element_size())) or (
            name == "cuda_core" and not 0 < d <= NARROW_MAX_D):
        raise ValueError(f"pairwise_sq_l2: no route {name!r} at D={d}")
    if _blocks(m, n, name) > _MAX_BLOCKS:
        raise ValueError(f"pairwise_sq_l2: {m} x {n} exceeds the grid")
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    if m == 0 or n == 0:
        return out
    wide = name != "cuda_core"
    lib = cuda_lib.library()
    # the wide route's prep pass writes the norms and the prepared
    # operands here
    scratch = torch.empty(
        lib.pairwise_sq_l2_scratch_bytes(code, _ROUTE_CODES[name], m, n, d),
        dtype=torch.uint8, device=q.device)
    index = q.device.index
    with cuda_lib.on_device(index):
        stream = cuda_lib.current_stream(index)
        err = lib.pairwise_sq_l2_launch(
            code, _ROUTE_CODES[name], q.data_ptr(), p.data_ptr(), m, n, d,
            scratch.data_ptr(), out.data_ptr(), stream,
        )
    cuda_lib.raise_on(err, "pairwise_sq_l2")
    LAUNCHES["pairwise_sq_l2"] += 2 if wide else 1  # device launches
    return out
