"""Quantized segment-coordinate storage: seal-time encode + error bound.

Sealed segments store their leaf coordinate buffer at a narrow width so
the fused traversal's phase-2 scan (`leaf_topk_l2_raw`) streams fewer
device-memory bytes — the dominant traffic of the memory-bound leaf
kernel. Exactness is NOT traded away: quantization only shapes
*candidate generation*. The kernel over-fetches k′ = k + slack
survivors by quantized distance, a rescore pass recomputes exact f32
distances for just those survivors, and a per-segment error bound
(`qerr`, computed here at seal time in f64) certifies that the
quantized top-k′ set contains the true top-k — falling back to the
all-f32 kernel when the slack is exhausted, never truncating.

Supported storage dtypes:

  * ``float32``  — identity (no side buffer, qerr = 0);
  * ``bfloat16`` — round-to-nearest-even cast (`Tensor.to`), bitwise
    the reference's `jnp.bfloat16` encoding; dequant is a plain widen;
  * ``int8``     — symmetric per-LEAF scale: the next POWER OF TWO
    above ``max|coord| / 127`` (f32, broadcast per candidate at
    stream time), dequant ``q * scale`` — exact in f32, so the
    kernel's keys are bitwise reproducible under any contraction.

The error bound is the max euclidean distance between any stored row
and its dequantized image, so for any query q and point p:
``|d(q, p) - d(q, p~)| <= ||p - p~|| <= qerr`` (triangle inequality).
A small multiplicative safety factor absorbs the f64->f32 boundary.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

SUPPORTED = ("float32", "bfloat16", "int8")

_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}

# safety factor on the seal-time error bound (same as the reference)
_QERR_SLACK = 1.0 + 2.0**-10


def check_dtype(storage_dtype: str) -> str:
    if storage_dtype not in SUPPORTED:
        raise ValueError(
            f"storage_dtype {storage_dtype!r} not one of {SUPPORTED}"
        )
    return storage_dtype


def torch_dtype(storage_dtype: str) -> torch.dtype:
    return _TORCH_DTYPES[check_dtype(storage_dtype)]


def dtype_name(dtype: torch.dtype) -> str:
    """Storage-dtype name of a torch dtype ("bfloat16", ...)."""
    return str(dtype).removeprefix("torch.")


def quantize_leaves(
    leaf_points: torch.Tensor, storage_dtype: str
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], float]:
    """Encode a padded (L, cap, d) f32 leaf buffer for storage.

    Returns ``(leaf_q, scale, qerr)`` on the buffer's device:

      * ``leaf_q`` — (L, cap, d) in the storage dtype (None for f32);
      * ``scale`` — (L,) f32 per-leaf dequant scales (int8 only);
      * ``qerr`` — conservative upper bound on the euclidean distance
        between any stored row and its dequantized image (f64 at seal,
        widened by `_QERR_SLACK`).
    """
    check_dtype(storage_dtype)
    if storage_dtype == "float32":
        return None, None, 0.0
    lp_dev = leaf_points.to(torch.float32)
    lp = lp_dev.cpu().numpy()
    if storage_dtype == "bfloat16":
        leaf_q = lp_dev.to(torch.bfloat16)
        deq = leaf_q.to(torch.float32).cpu().numpy().astype(np.float64)
        scale = None
    else:  # int8: symmetric per-leaf POWER-OF-TWO scale, zero-safe.
        # A pow2 scale makes the dequant product ``int8 * scale`` a pure
        # exponent shift — EXACT in f32 — so quantized keys are bitwise
        # identical between the kernel and its plain version.
        amax = np.abs(lp).max(axis=(1, 2)).astype(np.float32)  # (L,)
        mant, exp = np.frexp((amax / np.float32(127.0)).astype(np.float64))
        scale_np = np.where(mant == 0.5, np.exp2(exp - 1), np.exp2(exp))
        scale_np = np.where(amax > 0.0, scale_np, 1.0).astype(np.float32)
        qs = np.clip(
            np.rint(lp / scale_np[:, None, None]), -127, 127
        ).astype(np.int8)
        # dequant exactly as the kernel does: f32 widen, f32 multiply
        deq = np.asarray(
            qs.astype(np.float32) * scale_np[:, None, None], np.float64
        )
        leaf_q = torch.from_numpy(qs).to(leaf_points.device)
        scale = torch.from_numpy(scale_np).to(leaf_points.device)
    err = np.sqrt(
        ((np.asarray(lp, np.float64) - deq) ** 2).sum(axis=-1)
    ).max() if lp.size else 0.0
    return leaf_q, scale, float(err * _QERR_SLACK)


def dequantize(leaf_q: torch.Tensor, scale=None) -> torch.Tensor:
    """f32 image of a stored buffer, with the kernel's exact rounding
    (widen, then one f32 multiply by the broadcast scale)."""
    out = leaf_q.to(torch.float32)
    if scale is not None:
        s = scale.to(torch.float32)
        out = out * s.reshape(s.shape + (1,) * (out.ndim - s.ndim))
    return out


def itemsize_of(storage_dtype: str) -> int:
    """Bytes a stored coordinate takes in `storage_dtype`."""
    return torch_dtype(storage_dtype).itemsize


__all__ = [
    "SUPPORTED",
    "check_dtype",
    "torch_dtype",
    "dtype_name",
    "quantize_leaves",
    "dequantize",
    "itemsize_of",
]
