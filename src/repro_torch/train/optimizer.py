"""AdamW from scratch (a port of the reference's `train/optimizer.py`):
moments per parameter, global-norm clipping, linear warm-up + cosine
schedule.

Parameters, gradients and moments are ordered mappings of name -> tensor
(a model's `dict(named_parameters())`), the port's stand-in for the
reference's pytrees. The
state is {"m", "v": f32 tensors like the parameters, "step": int32 ()}.
Every operation of the reference's `upd` is repeated in its order, in
f32, one tensor at a time; `update` writes the new parameters and
moments into the given tensors in place (the port keeps one copy of each
where the reference returns new arrays) and returns them.
`torch.optim.AdamW` is not used: its step order and decay rule differ.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def init(params: Mapping[str, torch.Tensor]) -> dict:
    def zeros():  # on a mesh, placed as their parameters
        return {n: torch.zeros_like(p, dtype=torch.float32,
                                    memory_format=torch.contiguous_format)
                for n, p in params.items()}

    device = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32, summed tensor by
    tensor in the given order, each in its row-major order whatever its
    strides (a reduction follows the memory order, and autograd may lay a
    gradient out transposed on one path and not on another)."""
    total = None
    for x in tensors:
        sq = torch.sum(torch.square(x.to(torch.float32).contiguous()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor], state: dict,
           params: Mapping[str, torch.Tensor],
           ndims: Optional[Mapping[str, int]] = None) -> Tuple[dict, dict, dict]:
    """One AdamW step. Returns (params, state, {"grad_norm", "lr"}); the
    parameters and moments are updated in place. No weight decay on
    tensors of fewer than 2 dimensions (norms, biases): counted in
    `ndims` (a model's are its leaves' in the reference's tree,
    `convert.reference_ndims`, whatever shape the port stores them in),
    else the tensors' own."""
    gnorm = global_norm(grads[n] for n in params)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    step_f = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, step_f)
    b2c = 1 - torch.pow(cfg.b2, step_f)
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].to(torch.float32) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if (p.ndim if ndims is None else ndims[name]) >= 2:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
