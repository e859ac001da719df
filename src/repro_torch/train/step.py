"""Train step factory (a port of the reference's `train/step.py`): loss ->
gradients -> AdamW, with optional microbatch gradient accumulation.

`train_step(model, opt_state, batch)` differentiates `models.model.
loss_fn` with respect to the model's parameters (f32 masters, see
`models/model.py`) and updates them in place. With `accum_steps` > 1 the
batch is cut into that many microbatches along its first axis; their
f32 gradients are summed in order from zeros and scaled by
1/accum_steps once, as the reference's scan does, and so is the loss.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import convert
from ..models import model as model_lib
from ..models.config import ModelConfig
from . import optimizer as opt_lib


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.AdamWConfig,
                    accum_steps: int = 1) -> Callable:
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics). batch: {"inputs": (B, S[, d]), "labels": (B, S)}."""

    def grads_of(model, params, batch):
        loss, metrics = model_lib.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {n: (torch.zeros_like(p) if g is None else g.float())
                 for (n, p), g in zip(params.items(), grads)}
        return loss.detach(), metrics, grads

    def accumulated(model, params, batch):
        micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                              *v.shape[1:]) for k, v in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=model.device)
        grads_sum = {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in params.items()}
        for i in range(accum_steps):
            loss, _, grads = grads_of(model, params,
                                      {k: v[i] for k, v in micro.items()})
            loss_sum = loss_sum + loss
            grads_sum = {n: grads_sum[n] + grads[n] for n in params}
        inv = 1.0 / accum_steps
        return (loss_sum * inv, {},
                {n: g * inv for n, g in grads_sum.items()})

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        if accum_steps > 1:
            loss, metrics, grads = accumulated(model, params, batch)
        else:
            loss, metrics, grads = grads_of(model, params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        _, opt_state, opt_metrics = opt_lib.update(
            opt_cfg, grads, opt_state, params, convert.reference_ndims(cfg, params))
        return model, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step
