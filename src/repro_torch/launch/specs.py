"""Abstract inputs of every (arch × shape) cell (a port of the reference's
`launch/specs.py`): tensors on the `meta` device, which carry shapes and
dtypes and allocate nothing.

The reference builds `ShapeDtypeStruct`s with a `NamedSharding` from its
logical-axis `Rules`. Given `rules`, each spec here is a DTensor on
`META` placed as the reference's `_sds` places it: the parameters by
`sharding.shard_model` (the reference's shapes and specs), the moments
as their parameters, the batch and the decode token as ("batch", None),
the cache by its mixer's cache spec. Without `rules` a spec is the tensor
a call on one card would receive.
"""
from __future__ import annotations

from typing import List, Mapping, Tuple, Union

import torch

from ..configs.shapes import Shape
from ..models import model as model_lib
from ..models.config import ModelConfig
from ..models import sharding
from ..models.layers import COMPUTE_DTYPE
from ..train import optimizer as opt_lib

META = torch.device("meta")


def _empty(shape, dtype, rules, spec) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device=META)
    return t if rules is None else sharding.place(t, rules, spec)


def param_specs(cfg: ModelConfig, param_dtype: torch.dtype = COMPUTE_DTYPE,
                rules: sharding.Rules = None) -> model_lib.Model:
    """The model of `cfg` on `META`: its parameters by the reference's
    names and shapes, bf16 products' weights as `param_dtype` (bf16 to
    serve, f32 masters to train); placed by `rules` when given."""
    model = model_lib.Model(cfg, device=META, param_dtype=param_dtype)
    return model if rules is None else sharding.shard_model(model, rules)


def opt_specs(params: Union[torch.nn.Module, Mapping[str, torch.Tensor]]) -> dict:
    """AdamW's state of `params` (a model or a name -> tensor mapping):
    f32 moments like the parameters (placed as they are) and an int32
    step, on their device."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return opt_lib.init(params)


def batch_specs(cfg: ModelConfig, shape: Shape, rules=None) -> dict:
    """{"inputs": (B, S) int32 tokens or (B, S, d) bf16 embeddings,
    "labels": (B, S) int32}."""
    B, S = shape.batch, shape.seq
    if cfg.frontend == "tokens":
        inputs = _empty((B, S), torch.int32, rules, ("batch", None))
    else:
        inputs = _empty((B, S, cfg.d_model), COMPUTE_DTYPE, rules,
                        ("batch", None, None))
    labels = _empty((B, S), torch.int32, rules, ("batch", None))
    return {"inputs": inputs, "labels": labels}


def cache_specs(cfg: ModelConfig, shape: Shape, rules=None) -> List[dict]:
    """Per layer, the decode cache of `shape.batch` sequences with
    `shape.seq` slots (`models.model.cache_shapes`), in each mixer's own
    dtype, placed by its cache spec."""
    return [{name: _empty(sh, dt, rules, sharding.cache_spec(cfg, i, name))
             for name, (sh, dt) in layer.items()}
            for i, layer in enumerate(
                model_lib.cache_shapes(cfg, shape.batch, shape.seq))]


def decode_token_specs(cfg: ModelConfig, shape: Shape,
                       rules=None) -> Tuple[torch.Tensor, int]:
    """(the new tokens (B, 1) int32 or (B, 1, d) bf16, their position):
    the last slot of the cache, so the step attends over all of it (the
    reference's position is an abstract int32 scalar; the port's
    `decode_step` takes a Python int)."""
    B = shape.batch
    if cfg.frontend == "tokens":
        tok = _empty((B, 1), torch.int32, rules, ("batch", None))
    else:
        tok = _empty((B, 1, cfg.d_model), COMPUTE_DTYPE, rules, ("batch", None, None))
    return tok, shape.seq - 1
