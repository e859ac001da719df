"""Abstract inputs of every (arch × shape) cell (a port of the reference's
`launch/specs.py`): tensors on the `meta` device, which carry shapes and
dtypes and allocate nothing.

The reference builds `ShapeDtypeStruct`s with a `NamedSharding` from its
logical-axis `Rules`. One card has no sharding, so the port takes no
`Rules` argument and places nothing: a spec is the tensor a call on the
card would receive, on `META`.
"""
from __future__ import annotations

from typing import List, Mapping, Tuple, Union

import torch

from ..configs.shapes import Shape
from ..models import model as model_lib
from ..models.config import ModelConfig
from ..models.layers import COMPUTE_DTYPE
from ..train import optimizer as opt_lib

META = torch.device("meta")


def param_specs(cfg: ModelConfig,
                param_dtype: torch.dtype = COMPUTE_DTYPE) -> model_lib.Model:
    """The model of `cfg` on `META`: its parameters by the reference's
    names and shapes, bf16 products' weights as `param_dtype` (bf16 to
    serve, f32 masters to train)."""
    return model_lib.Model(cfg, device=META, param_dtype=param_dtype)


def opt_specs(params: Union[torch.nn.Module, Mapping[str, torch.Tensor]]) -> dict:
    """AdamW's state of `params` (a model or a name -> tensor mapping):
    f32 moments like the parameters and an int32 step, on their device."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return opt_lib.init(params)


def batch_specs(cfg: ModelConfig, shape: Shape) -> dict:
    """{"inputs": (B, S) int32 tokens or (B, S, d) bf16 embeddings,
    "labels": (B, S) int32}."""
    B, S = shape.batch, shape.seq
    if cfg.frontend == "tokens":
        inputs = torch.empty((B, S), dtype=torch.int32, device=META)
    else:
        inputs = torch.empty((B, S, cfg.d_model), dtype=COMPUTE_DTYPE, device=META)
    labels = torch.empty((B, S), dtype=torch.int32, device=META)
    return {"inputs": inputs, "labels": labels}


def cache_specs(cfg: ModelConfig, shape: Shape) -> List[dict]:
    """Per layer, the decode cache of `shape.batch` sequences with
    `shape.seq` slots (`models.model.cache_shapes`), in each mixer's own
    dtype."""
    return [{name: torch.empty(sh, dtype=dt, device=META)
             for name, (sh, dt) in layer.items()}
            for layer in model_lib.cache_shapes(cfg, shape.batch, shape.seq)]


def decode_token_specs(cfg: ModelConfig, shape: Shape) -> Tuple[torch.Tensor, int]:
    """(the new tokens (B, 1) int32 or (B, 1, d) bf16, their position):
    the last slot of the cache, so the step attends over all of it (the
    reference's position is an abstract int32 scalar; the port's
    `decode_step` takes a Python int)."""
    B = shape.batch
    if cfg.frontend == "tokens":
        tok = torch.empty((B, 1), dtype=torch.int32, device=META)
    else:
        tok = torch.empty((B, 1, cfg.d_model), dtype=COMPUTE_DTYPE, device=META)
    return tok, shape.seq - 1
