"""Shared modeling primitives (a port of the reference's `models/layers.py`):
RMSNorm, RoPE, dense products in the compute type, the SwiGLU / GELU
MLP, the init helpers and the cross entropy.

Numbers follow the reference operation by operation:

  * `matmul`: bf16 operands, f32 accumulation, one rounding to bf16. A
    bf16 x bf16 `torch.matmul` does exactly that on the CPU (it sums in
    f32 and rounds once; only the order of the sum differs from XLA's).
    On the card cuBLAS sums in f32 too, but PyTorch's default
    `torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`
    (True) lets it reduce split-K partial sums in bf16; the port leaves
    that flag as the caller set it, and the card tests hold the card
    against the CPU within their stated tolerance.
  * products whose result the reference keeps in f32 (attention scores,
    probabilities times values) take f32 operands holding the bf16
    values: every product is exact, the sum is f32.
  * `rms_norm` and `apply_rope` compute in f32 and round once.

The reference keeps f32 parameters and casts them to bf16 inside every
product, gather and bias add. For serving the port casts once, when the
weights are made or loaded (`models/model.py`), which gives the same
numbers; norm weights stay f32. For training it keeps f32 master weights,
as the reference does (`Model(param_dtype=torch.float32)`): every use
casts them to bf16 (`matmul`, the embedding gather, the bias adds), a
cast that is a no-op on the bf16 serving weights. Each module's init
takes that `param_dtype`, the storage type of its bf16 products'
weights (`stored`).

`cross_entropy` detaches the row max, as the reference's
`lax.stop_gradient` does.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


def stored(dtype: torch.dtype, param_dtype: torch.dtype) -> torch.dtype:
    """The storage type of a weight used in `dtype`: a bf16 product's
    weight is kept as `param_dtype`, any other as it is used."""
    return param_dtype if dtype == COMPUTE_DTYPE else dtype


# --------------------------------------------------------------------- #
def normal(shape, generator: torch.Generator, device, std: float = 0.02,
           dtype=COMPUTE_DTYPE) -> torch.Tensor:
    """N(0, std²) drawn in f32 from `generator`, stored as `dtype`."""
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=PARAM_DTYPE)
    return (x * std).to(dtype)


def fanin(shape, generator: torch.Generator, device, fan_axis: int = 0,
          dtype=COMPUTE_DTYPE) -> torch.Tensor:
    """N(0, 1/fan) with fan = shape[fan_axis], as the reference draws it."""
    return normal(shape, generator, device, std=shape[fan_axis] ** -0.5,
                  dtype=dtype)


def register_params(module, shapes: dict, device, generator,
                    param_dtype=COMPUTE_DTYPE) -> None:
    """Register `shapes` on `module` as frozen parameters, in order: a
    value (shape, fan_axis, dtype) is a fan-in normal drawn from
    `generator` (left empty without one, to be loaded or counted); a
    value (shape, None, dtype, fill) a constant. Each is stored as
    `stored(dtype, param_dtype)`."""
    for name, (shape, fan_axis, dtype, *fill) in shapes.items():
        dtype = stored(dtype, param_dtype)
        if fill:
            t = torch.full(shape, fill[0], dtype=dtype, device=device)
        elif generator is None:
            t = torch.empty(shape, dtype=dtype, device=device)
        else:
            t = fanin(shape, generator, device, fan_axis=fan_axis, dtype=dtype)
        module.register_parameter(name, nn.Parameter(t, requires_grad=False))


# --------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * w.float()
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    ar = torch.arange(0, hd, 2, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), ar / hd)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd) rotated by split halves; positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N), or the experts' batched (E, M, K) @ (E, K,
    N), in the compute type with f32 sums (see the module docstring),
    rounded once to bf16. On a mesh (w a DTensor) through
    `sharding.einsum`."""
    if isinstance(w, DTensor):
        from .sharding import einsum

        if w.ndim == 3:
            return einsum("emk,ekn->emn", x, w)
        lx = "abcdefgh"[:x.ndim - 1]
        return einsum(f"{lx}k,kn->{lx}n", x, w)
    return torch.matmul(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE))


def init_mlp(d: int, f: int, gated: bool, generator, device,
             dtype=COMPUTE_DTYPE) -> dict:
    """The reference's `init_mlp` shapes and draws: w_up (d, f) and w_down
    (f, d), plus w_gate (d, f) when gated, stored as `dtype`; returned in
    the reference's key order (gate, up, down)."""
    p = {}
    if gated:
        p["w_gate"] = fanin((d, f), generator, device, dtype=dtype)
    p["w_up"] = fanin((d, f), generator, device, dtype=dtype)
    p["w_down"] = fanin((f, d), generator, device, dtype=dtype)
    return p


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN (or the GELU MLP, tanh form, when ungated). x: (B, S, d);
    `params` maps "w_up", "w_down" and optionally "w_gate" to tensors."""
    u = matmul(x, params["w_up"])
    if "w_gate" in params:
        g = matmul(x, params["w_gate"])
        h = F.silu(g.float()).to(u.dtype) * u
    else:
        h = F.gelu(u.float(), approximate="tanh").to(u.dtype)
    return matmul(h, params["w_down"])


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable CE in f32. logits: (B, S, V); labels: (B, S) int.
    Returns (mean, per-token nll). On a mesh the vocab dim stays
    sharded (`_cross_entropy_mesh`)."""
    if isinstance(logits, DTensor):
        return _cross_entropy_mesh(logits, labels)
    lf = logits.float()
    m = lf.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    return nll.mean(), nll


def _cross_entropy_mesh(logits, labels):
    """`cross_entropy` of logits (B, S, V) sharded on the batch and, where
    the rules shard it, the vocab: the row max and the sum of exponentials
    are reduced across the vocab shards (an all-reduce each) and the gold
    logit is read where its vocab shard lives, never gathering the
    logits. Its numbers are the one-card formula's, summed in another
    order."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from .sharding import coordinate, region

    mesh = logits.device_mesh
    lp = list(logits.placements)
    vocab = [p.is_shard(2) for p in lp]
    row = [Shard(0) if p.is_shard(0) else Replicate() for p in lp]
    V = logits.shape[-1]
    n_vocab = 1
    for m, v in enumerate(vocab):
        if v:
            n_vocab *= mesh.shape[m]
    Vl = V // n_vocab
    lo = sum(coordinate(mesh, mesh.mesh_dim_names[m]) for m, v in enumerate(vocab)
             if v) * Vl  # one model axis shards the vocab

    mx = region(lambda l: l.float().amax(-1).detach(), (logits,), (lp,),
                [Partial("max") if v else r for v, r in zip(vocab, row)])
    mx = mx.redistribute(mesh, row)

    def sums(l, m, lab):
        lf = l.float()
        se = torch.exp(lf - m[..., None]).sum(-1)
        idx = lab.long() - lo
        inside = (idx >= 0) & (idx < Vl)
        gold = torch.gather(lf, -1, idx.clamp(0, Vl - 1)[..., None])[..., 0]
        return se, torch.where(inside, gold, torch.zeros_like(gold))

    part = [Partial() if v else r for v, r in zip(vocab, row)]
    se, gold = region(sums, (logits, mx, labels), (lp, row, row), (part, part))
    se = se.redistribute(mesh, row)
    gold = gold.redistribute(mesh, row)
    nll = torch.log(se) + mx - gold
    return nll.mean(), nll
