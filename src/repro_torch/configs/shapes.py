"""The assigned input-shape set and per-(arch × shape) applicability (a
copy of the reference's `configs/shapes.py`).

LM transformer shapes are seq_len × global_batch. decode_* / long_*
lower `decode_step` (one new token against a KV cache of seq_len), NOT
train_step. long_500k requires sub-quadratic attention and is SKIPPED
for pure full-attention architectures; it runs for SSM/hybrid/sliding-
window archs.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str        # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def sub_quadratic(cfg: ModelConfig) -> bool:
    """True if decode state is O(1)/O(window) for every layer."""
    for mixer, _ in cfg.layer_plan():
        if mixer == "attn" and not cfg.window:
            return False
        if mixer == "mla":  # full-attention latent cache grows with T
            return False
    return True


def applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    shape = SHAPES[shape_name]
    if shape.name == "long_500k" and not sub_quadratic(cfg):
        return False, "full-attention arch: 524k-token cache is not sub-quadratic (skip per assignment)"
    return True, ""


def cells(archs, shapes=None):
    """All (arch, shape) cells with applicability flags."""
    out = []
    for arch_name, cfg in archs.items():
        for shape_name in shapes or SHAPES:
            ok, why = applicable(cfg, shape_name)
            out.append((arch_name, shape_name, ok, why))
    return out
