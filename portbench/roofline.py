"""Operation and byte counts of the port's read-path kernels, and the
card's peaks, frozen.

The formulas are copied from `src/repro_torch/kernels/topk_l2.py`
(`leaf_block_plan`, `block_plan`: the function's arithmetic and the bytes
it must move, not the launch geometry). They count what the function
needs from its call's shapes: each input byte read once and each output
byte written once. The program's own counters (`kernel.flops`,
`kernel.hbm_bytes`) may change with it; these do not.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W limit:
3.35 TB/s of HBM and 67 TFLOP/s in float32 outside the tensor cores
(both kernels compute in f32 on the CUDA cores).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def leaf_topk(r: int, c: int, d: int, k: int, itemsize: int) -> tuple:
    """(flops, bytes) of one leaf top-k call over R rows of C candidates
    of D dims at storage width `itemsize` (4 f32, 2 bf16, 1 int8 with a
    per-candidate f32 scale), keeping k: the difference form, 3 operations
    a dim (4 with the int8 scale) and 2 compares a candidate; each row's
    query, candidates, gids and gate read once, the (R, k) triple of
    (distance, gid, slot) written once."""
    scaled = itemsize == 1
    flops = r * c * ((4 if scaled else 3) * d + 2)
    nbytes = (r * d * 4 + r * c * d * itemsize + r * c * 4
              + (r * c * 4 if scaled else 0) + r * 4 + r * k * 12)
    return flops, nbytes


def topk_l2(m: int, n: int, d: int, k: int) -> tuple:
    """(flops, bytes) of one shared-points top-k call (the delta-arena
    scan): Q = m queries against N = n points of D dims; per pair the
    expansion-form dot (2 a dim) and 5 more, plus one |q|² and one |p|²
    each; q, p, gids and the gate read once, the (Q, k) triple written
    once."""
    flops = m * n * (2 * d + 5) + 2 * d * (m + n)
    nbytes = m * d * 4 + n * d * 4 + n * 4 + m * 4 + m * k * 12
    return flops, nbytes


FORMULAS = {"leaf_topk": leaf_topk, "topk_l2": topk_l2}


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    at the f32 rate and the bytes at the HBM rate."""
    return max(flops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
