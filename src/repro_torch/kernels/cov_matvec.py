"""Centered-covariance matvec (one power-iteration step): CUDA kernel +
plain version.

Port of the reference's `kernels/cov_matvec.py` (one Pallas TPU kernel):
y = (X − μ)ᵀ((X − μ)w) for x (N, D) in f32 or bf16, f32 mean and w (D,).
The function exists twice here:

  * a hand-written CUDA kernel (`csrc/cov_matvec.cu`), launched by
    `cov_matvec_cuda`, which counts its device launches in `LAUNCHES`:
    one per call. Each block reads its rows of x once and writes a
    per-block partial; the last block to finish folds the partials in a
    fixed order — no float atomics, so y is bitwise reproducible. The
    last block is found by an atomic ticket: one uint32 counter per CUDA
    stream (`cuda_lib.ticket_counters`), zeroed when it is made and reset
    to 0 by the last block, so eager calls on two streams never share one
    and calls on one stream run in order (a CUDA graph that holds a call
    is replayed on its capture stream; see `ticket_counters`). Two routes,
    chosen by D alone: up to 2,048 columns a thread keeps the column sums
    of up to eight columns in registers and 16 KB tiles hold whole rows;
    wider rows (`WIDE_MIN_D` and up) take the wide route, one row a warp
    for the dot and the D column sums in shared memory (or, past 57,344
    columns, in the block's partial row), in the same order of sums, so
    any D runs;
  * a plain PyTorch version (`cov_matvec_plain`) that repeats the
    kernel's order of sums with whole-tensor operations — each row's dot
    by `row_lanes(D)` lanes (strided columns, a rotated start for rows
    wider than 4, then a halving tree), each block's rows split into
    `groups` strided sequences, the group fold (a halving tree within a
    warp, then one over the warps), then the cross-block fold over
    strided sequences of blocks and the same group fold — so the two
    agree bitwise.

`kernels/ops.py` picks one by the tensors' device.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import cuda_lib

# device launches since the last reset, one per call (never counted by the
# plain version)
LAUNCHES = {"cov_matvec": 0}

_THREADS = 256          # threads per block (csrc/cov_matvec.cu)
_WARP = 32
_TILE_VALUES = 4096     # values per tile, at most (csrc/cov_matvec.cu)
_TARGET_BLOCKS = 264    # the grid aims at this many blocks (two per H100 SM)
WIDE_MIN_D = 2049       # wider rows take the wide route (csrc/cov_matvec.cu)
_ROW_DOT_MAX_D = 4      # wider rows start their dot rotated by the row


def route(d: int) -> str:
    """The kernel's route for rows of D values: "tile" up to 2,048, then
    "wide"."""
    return "wide" if d >= WIDE_MIN_D else "tile"


def _layout(d: int):
    """(CW, G, GW, NW): columns a block spans at once (a power of two, at
    most 256), row groups G = 256 / CW, groups per warp GW and warp sums
    NW = G / GW of the kernel's thread layout."""
    cw = 1
    while cw < d and cw < _THREADS:
        cw <<= 1
    groups = _THREADS // cw
    gw = _WARP // cw if cw < _WARP else 1
    return cw, groups, gw, groups // gw


def tile_rows(d: int) -> int:
    """Rows per tile: a multiple of the row groups, at most 4,096 values
    (16 KB of f32) in a tile, at least one group's worth of rows."""
    _, groups, _, _ = _layout(d)
    return groups * max(1, _TILE_VALUES // (groups * d))


def geometry(n: int, d: int):
    """(rows_per_block, blocks, groups) — a function of the shape alone,
    so the sum order (and y) never depends on the card: whole tiles per
    block, as many as spread the rows over about `_TARGET_BLOCKS` blocks."""
    _, groups, _, _ = _layout(d)
    tile = tile_rows(d)
    tiles = max(1, -(-n // tile))
    rows_per_block = tile * -(-tiles // _TARGET_BLOCKS)
    return rows_per_block, max(1, -(-n // rows_per_block)), groups


def block_plan(n: int, d: int, itemsize: int = 4) -> dict:
    """Cost of one call as the CUDA kernel runs it: `blocks` is the grid
    of its one launch (the last block to finish also folds the partials);
    `flops` is the function's arithmetic, two matvecs over the centered
    rows (4ND); `hbm_bytes` is what the function must move — x read once
    at its width, mean and w read once and y written once in f32."""
    _, blocks, _ = geometry(n, d)
    return {
        "blocks": blocks,
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


def _fold_groups(acc: torch.Tensor, d: int) -> torch.Tensor:
    """The kernel's group fold of (..., G, D) sums: a halving tree over
    each warp's GW groups (the xor-shuffles), then one over the NW warp
    sums; returns (..., D)."""
    _, groups, gw, nw = _layout(d)
    acc = acc.reshape(*acc.shape[:-2], nw, gw, d)
    return _halve(_halve(acc, gw, acc.dim() - 2), nw, acc.dim() - 3)


def row_lanes(d: int) -> int:
    """Lanes that share one row's dot t: a power of two, at most 32 and at
    most D, as many as the tile's rows leave of the block's threads (1
    where the tile has 256 rows or more)."""
    rows, lanes = tile_rows(d), 1
    while lanes * 2 <= min(_WARP, d) and lanes * 2 * rows <= _THREADS:
        lanes *= 2
    return lanes


def _row_dots(xc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """t = xc·w per row in the kernel's order: P = row_lanes(D) lanes a
    row, lane q summing columns q + P·s from 0 for s = 0 .. S−1 in turn
    (rows wider than `_ROW_DOT_MAX_D` start at s = (row mod 32) mod S and
    wrap around), then a halving tree over the P lane sums."""
    n, d = xc.shape
    lanes = row_lanes(d)
    steps = -(-d // lanes)
    prod = F.pad(xc * w[None, :], (0, lanes * steps - d))
    prod = prod.reshape(n, steps, lanes)   # [:, s, q] is column q + P·s
    if d > _ROW_DOT_MAX_D:
        start = (torch.arange(n, device=xc.device) % _WARP) % steps
        order = (torch.arange(steps, device=xc.device)[None, :] + start[:, None]) % steps
        prod = torch.gather(prod, 1, order[:, :, None].expand(n, steps, lanes))
    acc = torch.zeros((n, lanes), dtype=torch.float32, device=xc.device)
    for s in range(steps):
        acc = acc + prod[:, s]
    return _halve(acc, lanes, 1)


def cov_matvec_plain(x: torch.Tensor, mean: torch.Tensor, w: torch.Tensor):
    """Plain version: x (N, D) f32 / bf16, mean and w (D,) f32 -> (D,) f32."""
    n, d = x.shape
    if n == 0:
        return torch.zeros(d, dtype=torch.float32, device=x.device)
    xc = x.to(torch.float32) - mean[None, :]
    t = _row_dots(xc, w)
    prod = t[:, None] * xc
    rows, blocks, groups = geometry(n, d)
    prod = F.pad(prod, (0, 0, 0, blocks * rows - n))  # zero rows add nothing
    prod = prod.reshape(blocks, rows // groups, groups, d)
    acc = torch.zeros((blocks, groups, d), dtype=torch.float32, device=x.device)
    for m in range(rows // groups):  # group g: rows g, g + groups, ... in order
        acc = acc + prod[:, m]
    partial = _fold_groups(acc, d)                        # (blocks, d)
    chunks = -(-blocks // groups)
    partial = F.pad(partial, (0, 0, 0, chunks * groups - blocks))
    partial = partial.reshape(chunks, groups, d)
    v = torch.zeros((groups, d), dtype=torch.float32, device=x.device)
    for c in range(chunks):  # group f: blocks f, f + groups, ... in order
        v = v + partial[c]
    return _fold_groups(v, d)


@functools.lru_cache(maxsize=256)
def _launch_args(n: int, d: int):
    """(tile_rows, rows_per_block, row_lanes, blocks) of one launch, kept
    per shape: the Python that computes them costs microseconds a call."""
    rows, blocks, _ = geometry(n, d)
    return tile_rows(d), rows, row_lanes(d), blocks


def cov_matvec_cuda(x: torch.Tensor, mean: torch.Tensor, w: torch.Tensor):
    """Launch the kernel (same contract as `cov_matvec_plain`)."""
    code = {torch.float32: 0, torch.bfloat16: 1}.get(x.dtype)
    if code is None or x.dim() != 2:
        raise ValueError(f"cov_matvec: x must be (N, D) f32 or bf16, got {x.dtype}")
    n, d = x.shape
    if d < 1:
        raise ValueError(f"cov_matvec: D={d}, need at least one column")
    device = x.device
    for name, t in (("x", x), ("mean", mean), ("w", w)):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"cov_matvec: {name} must be contiguous on {device}")
    for name, t in (("mean", mean), ("w", w)):
        if t.dtype != torch.float32 or tuple(t.shape) != (d,):
            raise ValueError(f"cov_matvec: {name} must be f32 ({d},)")
    if n == 0:
        return torch.zeros(d, dtype=torch.float32, device=device)
    tile, rows, lanes, blocks = _launch_args(n, d)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=device)
    y = torch.empty(d, dtype=torch.float32, device=device)
    lib = cuda_lib.library()
    index = device.index
    with cuda_lib.on_device(index):
        stream = cuda_lib.current_stream(index)
        ticket = cuda_lib.ticket_counters(index, stream, 1)
        err = lib.cov_matvec_launch(
            code, x.data_ptr(), mean.data_ptr(), w.data_ptr(), n, d, tile,
            rows, lanes, partial.data_ptr(), ticket.data_ptr(), y.data_ptr(),
            stream,
        )
    cuda_lib.raise_on(err, "cov_matvec")
    LAUNCHES["cov_matvec"] += 1
    return y
