"""Model assembly: config -> parameters / forward / prefill / decode.

A port of the reference's `models/model.py` for all ten configs: GQA,
MLA, RG-LRU and mLSTM / sLSTM mixers (`MIXERS`) with dense, MoE or no
FFNs (xlstm-125m's blocks carry their projections and have none). The
reference stacks a scan group's layers on a leading axis and scans them;
the port holds a `ModuleList` of layers in the same order
(`ModelConfig.scan_groups`), and a per-layer list of caches, each in its
mixer's own dtype: bf16 attention caches, f32 recurrent states.

Every entry point runs on the device its model lives on. `init_params`
puts a model on "cuda" unless the caller asks for the CPU, and raises
where there is no card.

Serving keeps bf16 products' weights in bf16. Training builds the model
with f32 master weights (`param_dtype=torch.float32`, as the reference
keeps every parameter), cast to bf16 at each use, and runs
`forward(..., training=True)` / `loss_fn` with autograd on: each block
under `torch.utils.checkpoint` when `cfg.remat == "full"` (the reference
checkpoints its scanned groups' bodies; the numbers are the same).
Decode and prefill stay under `no_grad`.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention
from . import moe as moe_mod
from . import recurrent, xlstm
from .config import ModelConfig
from . import sharding
from .layers import (COMPUTE_DTYPE, PARAM_DTYPE, cross_entropy, init_mlp,
                     matmul, mlp, normal, rms_norm)
from .sharding import constrain, on_mesh

# mixer registry: kind -> (init, apply, decode, cache_shape, prefill)
MIXERS = {
    "attn": (
        attention.init_attn,
        attention.attn,
        attention.attn_decode,
        attention.attn_cache_shape,
        attention.attn_prefill,
    ),
    "mla": (
        attention.MLA,
        attention.mla,
        attention.mla_decode,
        attention.mla_cache_shape,
        attention.mla_prefill,
    ),
    "rglru": (
        recurrent.RGLRU,
        recurrent.rglru,
        recurrent.rglru_decode,
        recurrent.rglru_cache_shape,
        recurrent.rglru_prefill,
    ),
    "mlstm": (
        xlstm.MLSTM,
        xlstm.mlstm,
        xlstm.mlstm_decode,
        xlstm.mlstm_cache_shape,
        xlstm.mlstm_prefill,
    ),
    "slstm": (
        xlstm.SLSTM,
        xlstm.slstm,
        xlstm.slstm_decode,
        xlstm.slstm_cache_shape,
        xlstm.slstm_prefill,
    ),
}


def resolve_device(device) -> torch.device:
    """`device` as a torch device, "cuda" with the current card's index;
    a CUDA device where there is no card raises (nothing falls back to
    the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's model runs on the card; pass "
                "device='cpu' to run it on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ===================================================================== #
# parameters
# ===================================================================== #
def _vector(d: int, fill: float, device) -> nn.Parameter:
    t = torch.full((d,), fill, dtype=PARAM_DTYPE, device=device)
    return nn.Parameter(t, requires_grad=False)


def init_ffn(cfg: ModelConfig, device, generator=None,
             param_dtype=COMPUTE_DTYPE) -> nn.ParameterDict:
    """The dense FFN's weights by the reference's names ("w_gate" when
    gated, "w_up", "w_down"), drawn as `init_mlp` draws them, or empty;
    stored as `param_dtype`."""
    d, f = cfg.d_model, cfg.d_ff
    if generator is not None:
        ws = init_mlp(d, f, cfg.mlp_gated, generator, device, param_dtype)
    else:
        names = (("w_gate",) if cfg.mlp_gated else ()) + ("w_up", "w_down")
        ws = {n: torch.empty((f, d) if n == "w_down" else (d, f),
                             dtype=param_dtype, device=device)
              for n in names}
    return nn.ParameterDict(
        {n: nn.Parameter(t, requires_grad=False) for n, t in ws.items()})


class Block(nn.Module):
    """One (mixer, ffn) layer: pre-norm mixer and pre-norm FFN (dense or
    MoE; "none": no norm2, no FFN), each with a residual add."""

    def __init__(self, cfg: ModelConfig, kind: Tuple[str, str], device,
                 generator=None, param_dtype=COMPUTE_DTYPE):
        super().__init__()
        mixer, ffn = kind
        self.kind = kind
        self.norm1 = _vector(cfg.d_model, 1.0, device)
        self.mixer = MIXERS[mixer][0](cfg, device, generator, param_dtype)
        if ffn == "dense":
            self.norm2 = _vector(cfg.d_model, 1.0, device)
            self.ffn = init_ffn(cfg, device, generator, param_dtype)
        elif ffn == "moe":
            self.norm2 = _vector(cfg.d_model, 1.0, device)
            self.ffn = moe_mod.MoE(cfg, device, generator, param_dtype)


class Model(nn.Module):
    """The decoder stack's parameters, in the reference's layer order.
    bf16 products' weights are stored as `param_dtype`: bf16 for serving
    (the reference casts its f32 parameters to bf16 at every use: the same
    numbers), f32 masters for training; norms and the weights of f32
    arithmetic stay f32 either way."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 param_dtype: torch.dtype = COMPUTE_DTYPE):
        super().__init__()
        self.cfg = cfg
        dev = torch.device(device)

        def table(shape, std):
            if generator is None:
                t = torch.empty(shape, dtype=param_dtype, device=dev)
            else:
                t = normal(shape, generator, dev, std=std, dtype=param_dtype)
            return nn.Parameter(t, requires_grad=False)

        d, V = cfg.d_model, cfg.vocab
        if cfg.frontend == "tokens":
            self.embed = table((V, d), 0.02)
        self.layers = nn.ModuleList(
            Block(cfg, kind, dev, generator, param_dtype)
            for kind in cfg.layer_plan())
        self.final_norm = _vector(d, 1.0, dev)
        if cfg.frontend != "tokens" or not cfg.tied_embeddings:
            self.unembed = table((d, V), d ** -0.5)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


def init_params(cfg: ModelConfig, seed: Union[int, torch.Generator] = 0,
                device="cuda", param_dtype: torch.dtype = COMPUTE_DTYPE) -> Model:
    """A model of `cfg` with random weights on `device`, drawn from
    `seed` (an int, or a `torch.Generator` on that device) with the
    reference's distributions and shapes (not its numbers: the reference
    draws from `jax.random`); bf16 products' weights stored as
    `param_dtype` (`Model`)."""
    dev = resolve_device(device)
    gen = seed
    if not isinstance(seed, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    with torch.no_grad():
        return Model(cfg, dev, gen, param_dtype)


def param_count(cfg: ModelConfig) -> int:
    """The parameter count, from shapes on the meta device (nothing is
    allocated); equal to the reference's `param_count`."""
    model = Model(cfg, device="meta")
    return int(sum(p.numel() for p in model.parameters()))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters used per token: the routed experts' weights (w_gate,
    w_up, w_down of an MoE FFN) count top_k / n_experts of their size,
    everything else in full. Equal to the reference's count at every
    published config. (The reference's rule also scales any unstacked
    3-D weight whose first axis equals n_experts; at full size there is
    none, at reduced size deepseek's first-layer w_o (4, 16, 64) is one.)"""
    model = Model(cfg, device="meta")
    total = 0
    for module in model.modules():
        routed = isinstance(module, moe_mod.MoE)
        for name, p in module.named_parameters(recurse=False):
            n = p.numel()
            if routed and name != "router":
                n = n * cfg.top_k // cfg.n_experts
            total += n
    return int(total)


# ===================================================================== #
# apply
# ===================================================================== #
def _apply_block(block: Block, h, positions, cfg: ModelConfig, cache=None,
                 pos=None, cache_len: int = 0):
    """One block. Returns (h, aux, new_cache): aux is the MoE FFN's
    load-balance loss (f32), None for a dense block.

    cache is None, cache_len=0   -> plain forward
    cache is None, cache_len>0   -> prefill (forward + cache emission)
    cache is a dict              -> single-token decode
    """
    mixer, ffn = block.kind
    _, apply_fn, decode_fn, _, prefill_fn = MIXERS[mixer]
    hin = rms_norm(h, block.norm1, cfg.norm_eps)
    new_cache = None
    if cache is not None:
        y, new_cache = decode_fn(block.mixer, hin, cache, pos, cfg)
    elif cache_len:
        y, new_cache = prefill_fn(block.mixer, hin, positions, cfg, cache_len)
    else:
        y = apply_fn(block.mixer, hin, positions, cfg)
    h = h + y
    aux = None
    if ffn == "dense":
        h = h + mlp(block.ffn, rms_norm(h, block.norm2, cfg.norm_eps))
    elif ffn == "moe":
        y, aux = block.ffn(rms_norm(h, block.norm2, cfg.norm_eps), cfg)
        h = h + y
    return constrain(h, "batch", "seq", None), aux, new_cache


def _embed_in(model: Model, inputs):
    if on_mesh(model.final_norm):
        h = _embed_mesh(model, inputs)
    elif model.cfg.frontend == "tokens":
        h = model.embed[inputs.to(model.device).long()].to(COMPUTE_DTYPE)
    else:
        h = inputs.to(model.device).to(COMPUTE_DTYPE)
    return constrain(h, "batch", "seq", None)


def _embed_mesh(model: Model, inputs):
    """The embedding on a mesh: inputs placed (batch, ...); the table's
    data (FSDP) shard gathered, its vocab shard kept: each rank looks up
    the ids in its vocab rows, and the rows are summed across the vocab
    shards (one of them holds each id)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    fin = model.final_norm
    if not on_mesh(inputs):
        inputs = sharding.replicated(inputs.to(fin.device), fin)
    inputs = constrain(inputs, "batch", *([None] * (inputs.ndim - 1)))
    if model.cfg.frontend != "tokens":
        return inputs.to(COMPUTE_DTYPE)
    table = model.embed
    mesh = table.device_mesh
    row = sharding.row_placements_of(list(inputs.placements))
    t_pl = [pl if pl.is_shard(0) else Replicate() for pl in table.placements]
    vocab = [pl.is_shard(0) for pl in t_pl]
    Vl = table.shape[0] // math.prod(mesh.shape[m] for m, v in enumerate(vocab) if v)
    lo = sum(sharding.coordinate(mesh, mesh.mesh_dim_names[m])
             for m, v in enumerate(vocab) if v) * Vl

    def look(tl, ids):
        idx = ids.long() - lo
        inside = (idx >= 0) & (idx < tl.shape[0])
        rows = tl[idx.clamp(0, tl.shape[0] - 1)] * inside[..., None]
        return rows.to(COMPUTE_DTYPE)

    out = [Partial() if v else r for v, r in zip(vocab, row)]
    return sharding.region(look, (table, inputs), (t_pl, row), out,
                           (sharding.partial_where_batch(t_pl, row), row))


def _logits_out(model: Model, h):
    cfg = model.cfg
    h = rms_norm(h, model.final_norm, cfg.norm_eps)
    if cfg.frontend == "tokens" and cfg.tied_embeddings:
        logits = matmul(h, model.embed.t())
    else:
        logits = matmul(h, model.unembed)
    return constrain(logits, "batch", None, "vocab")


def _positions(B: int, S: int, device, like=None):
    """The positions (B, S) int32; on a mesh (`like` a DTensor) replicated
    on its mesh."""
    pos = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    if on_mesh(like):
        return sharding.replicated(pos.contiguous(), like)
    return pos


def _zero(model: Model):
    """The f32 scalar 0 of the aux sums, replicated on a mesh."""
    z = torch.zeros((), dtype=torch.float32, device=model.device)
    if on_mesh(model.final_norm):
        return sharding.replicated(z, model.final_norm)
    return z


def forward(model: Model, inputs, training: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """inputs: (B, S) int tokens or (B, S, d) embeddings. Returns
    (logits (B, S, vocab) bf16, the MoE layers' aux loss summed in f32 —
    0 for a dense config). Without `training` it runs under `no_grad`;
    with it autograd records it, each block checkpointed when
    `cfg.remat == "full"`."""
    if not training:
        with torch.no_grad():
            return _forward(model, inputs, False)
    return _forward(model, inputs, model.cfg.remat == "full")


def _forward(model: Model, inputs, remat: bool):
    cfg = model.cfg
    B, S = inputs.shape[:2]
    positions = _positions(B, S, model.device, model.final_norm)
    h = _embed_in(model, inputs)
    aux = _zero(model)
    for block in model.layers:
        if remat:
            h, block_aux, _ = checkpoint(_apply_block, block, h, positions,
                                         cfg, use_reentrant=False)
        else:
            h, block_aux, _ = _apply_block(block, h, positions, cfg)
        if block_aux is not None:
            aux = aux + block_aux
    return _logits_out(model, h), aux


def loss_fn(model: Model, batch: dict):
    """Next-token CE of batch {"inputs": (B, S[, d]), "labels": (B, S)}
    (logits[:, :-1] against labels[:, 1:]) plus the MoE aux loss. Returns
    (loss, {"ce", "aux"}), f32 scalars."""
    logits, aux = forward(model, batch["inputs"], training=True)
    labels = batch["labels"].to(logits.device)
    if on_mesh(logits):
        logits = sharding.local(lambda t: t[:, :-1], logits)
        labels = sharding.local(lambda t: t[:, 1:], labels)
    else:
        logits, labels = logits[:, :-1], labels[:, 1:]
    ce, _ = cross_entropy(logits, labels)
    return ce + aux, {"ce": ce, "aux": aux}


# ===================================================================== #
# serving
# ===================================================================== #
def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int) -> List[dict]:
    """Per layer, {name: (shape, dtype)} of its decode cache, in the
    mixer's own dtype."""
    return [MIXERS[mixer][3](cfg, batch, cache_len)
            for mixer, _ in cfg.layer_plan()]


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device="cuda") -> List[dict]:
    dev = resolve_device(device)
    return [{name: torch.zeros(shape, dtype=dtype, device=dev)
             for name, (shape, dtype) in layer.items()}
            for layer in cache_shapes(cfg, batch, cache_len)]


@torch.no_grad()
def decode_step(model: Model, cache: List[dict], tokens, pos: int):
    """One decode step. tokens: (B, 1) int (or (B, 1, d) embeddings);
    pos: the new token's position. Returns (logits (B, 1, vocab), cache);
    the cache is updated in place."""
    cfg = model.cfg
    h = _embed_in(model, tokens)
    for block, layer_cache in zip(model.layers, cache):
        h, _, _ = _apply_block(block, h, None, cfg, cache=layer_cache, pos=int(pos))
    return _logits_out(model, h), cache


@torch.no_grad()
def prefill(model: Model, tokens, cache_len: int):
    """Process a full prompt, returning (logits, decode cache).

    tokens: (B, S) int (or (B, S, d) embeddings). The emitted cache has
    time capacity `cache_len` (rolling min(window, cache_len) buffers for
    sliding-window attention) and plugs directly into decode_step at
    pos = S."""
    cfg = model.cfg
    B, S = tokens.shape[:2]
    positions = _positions(B, S, model.device, model.final_norm)
    h = _embed_in(model, tokens)
    caches = []
    for block in model.layers:
        h, _, c = _apply_block(block, h, positions, cfg, cache_len=cache_len)
        caches.append(c)
    return _logits_out(model, h), caches
