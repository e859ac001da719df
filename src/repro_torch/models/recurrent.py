"""Griffin / RecurrentGemma recurrent block: a gated causal temporal conv
and the RG-LRU. A port of the reference's `models/recurrent.py`.

The linear recurrence h_t = a_t·h_{t-1} + b_t is associative. The
reference evaluates it with `jax.lax.associative_scan`; PyTorch has no
such primitive, and the port runs a Hillis–Steele doubling instead
(`linear_scan`): ⌈log2 S⌉ steps over the whole (B, S, dr) tensors, the
reference's log-depth parallel structure in another combine order (f32,
so the two agree to rounding, not bitwise). Decode carries (h, the last
cw - 1 pre-conv inputs) and costs O(1) a token.

Weights keep the dtype of the reference's use of them: w_x, w_gate and
w_out go through bf16 products and are stored bf16; conv_w multiplies
the bf16 input with promotion to f32, and the block-diagonal gates w_r,
w_i, their biases and lam enter f32 arithmetic, so all of those stay f32.
conv_b is rounded to bf16 in forward and prefill and added in f32 in
decode, as the reference does; it is stored f32.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from . import sharding
from .config import ModelConfig
from .layers import COMPUTE_DTYPE, PARAM_DTYPE, matmul, register_params
from .sharding import on_mesh

RG_LRU_C = 8.0


class RGLRU(nn.Module):
    """The recurrent block's parameters by the reference's names: w_x,
    w_gate (d, dr) and w_out (dr, d) bf16; conv_w (cw, dr), conv_b (dr,),
    w_r, w_i (nh, dh, dh), b_r, b_i and lam (dr,) f32. With a `generator`
    the weights are drawn as the reference's `init_rglru` draws them;
    without one they are left empty, to be loaded. The biases are zeros
    and lam its fixed init either way."""

    def __init__(self, cfg: ModelConfig, device, generator=None,
                 param_dtype=COMPUTE_DTYPE):
        super().__init__()
        d, dr, cw = cfg.d_model, cfg.d_rnn or cfg.d_model, cfg.conv_width
        nh = cfg.n_heads
        dh = dr // nh
        f32 = PARAM_DTYPE
        register_params(self, {
            "w_x": ((d, dr), 0, COMPUTE_DTYPE),
            "w_gate": ((d, dr), 0, COMPUTE_DTYPE),
            "conv_w": ((cw, dr), 0, f32),
            "conv_b": ((dr,), None, f32, 0.0),
            "w_r": ((nh, dh, dh), 1, f32),
            "w_i": ((nh, dh, dh), 1, f32),
            "b_r": ((dr,), None, f32, 0.0),
            "b_i": ((dr,), None, f32, 0.0),
            "lam": ((dr,), None, f32, 0.0),
            "w_out": ((dr, d), 0, COMPUTE_DTYPE),
        }, device, generator, param_dtype)
        if self.lam.device.type != "meta":
            # a = sigmoid(lam)^c lands in [0.9, 0.999] (Griffin A.2)
            lam = torch.log(torch.linspace(0.9, 0.999, dr, dtype=f32) ** (1.0 / RG_LRU_C))
            self.lam.copy_(lam - torch.log1p(-torch.exp(lam)))


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t along axis 1 from h_{-1} = 0, by
    Hillis–Steele doubling: after the step of stride k, (a_t, b_t) holds
    the composition of the 2k elements ending at t."""
    S = a.shape[1]
    k = 1
    while k < S:
        b = torch.cat([b[:, :k], torch.addcmul(b[:, k:], b[:, :-k], a[:, k:])], 1)
        if 2 * k < S:
            a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], 1)
        k *= 2
    return b


def _blockdiag(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., nh·dh) @ block-diag (nh, dh, dh) -> (..., nh·dh), f32."""
    nh, dh, _ = w.shape
    uh = u.reshape(*u.shape[:-1], nh, dh)
    return torch.einsum("...hd,hde->...he", uh, w).reshape(u.shape)


def _gates(p: RGLRU, u: torch.Tensor):
    """The RG-LRU's (a, b) of the conv output u (..., dr), f32."""
    uf = u.float()
    r = torch.sigmoid(_blockdiag(uf, p.w_r) + p.b_r)
    i = torch.sigmoid(_blockdiag(uf, p.w_i) + p.b_i)
    log_a = -RG_LRU_C * r * F.softplus(p.lam)  # <= 0
    a = torch.exp(log_a)
    sqrt1m = torch.sqrt(-torch.expm1(2.0 * log_a))  # sqrt(1 - a²), stable
    return a, sqrt1m * i * uf


def _branches(p: RGLRU, x):
    """The pre-conv input u (bf16) and the GELU gate g (f32) of x."""
    u = matmul(x, p.w_x)
    g = F.gelu(matmul(x, p.w_gate).float(), approximate="tanh")
    return u, g


def _core(p, u, g, cfg: ModelConfig):
    """The conv, the gates and the scan of the branches u, g (B, S, dr):
    (y (B, S, dr) bf16, h the f32 states). `p` holds conv_w, conv_b and
    the gates' weights (the module, or one rank's shards of them)."""
    cw = cfg.conv_width
    S = u.shape[1]
    pad = F.pad(u, (0, 0, cw - 1, 0))
    # causal depthwise conv: bf16 taps times f32 weights, summed left to right
    conv = sum(pad[:, i:i + S] * p.conv_w[i] for i in range(cw)) + p.conv_b.to(u.dtype)
    a, b = _gates(p, conv)
    h = linear_scan(a, b)
    return (h * g).to(COMPUTE_DTYPE), h


def _rglru(p: RGLRU, x, cfg: ModelConfig):
    """The block over a whole sequence: (output, u, h), h the f32 states."""
    u, g = _branches(p, x)
    y, h = _core(p, u, g, cfg)
    return matmul(y, p.w_out), u, h


# on a mesh: the conv, gates and scan run on each rank's batch rows and
# channels (the reference's constraint (batch, None, tp)); the weights
# they use are cut to the rank's channels, whole heads of the
# block-diagonal gates
_LOCAL = {"conv_w": 1, "conv_b": 0, "w_r": 0, "w_i": 0, "b_r": 0, "b_i": 0,
          "lam": 0}


def _mesh_layout(p: RGLRU, u, cfg: ModelConfig):
    """(the branches' placements, the state's, the local weights'
    placements and their gradients')."""
    rules = sharding.current_rules()
    mesh = u.device_mesh
    c_pl = rules.placements(u.shape, ("batch", None, "tp"))
    c_pl = [Replicate() if pl.is_shard(2) and cfg.n_heads % mesh.shape[m] else pl
            for m, pl in enumerate(c_pl)]
    h_pl = [Shard(1) if pl.is_shard(2) else pl for pl in c_pl]
    row = sharding.row_placements_of(c_pl)
    w_pl = [[Shard(dim) if pl.is_shard(2) else Replicate() for pl in c_pl]
            for dim in _LOCAL.values()]
    w_grad = [sharding.partial_where_batch(pl, row) for pl in w_pl]
    return c_pl, h_pl, w_pl, w_grad


def _local(ws):
    return SimpleNamespace(**dict(zip(_LOCAL, ws)))


def _rglru_mesh(p: RGLRU, x, cfg: ModelConfig):
    """`_rglru` on a mesh: (output, the last state h (B, dr), the last
    cw - 1 pre-conv inputs (B, cw - 1, dr) f32)."""
    keep = cfg.conv_width - 1
    u, g = _branches(p, x)
    c_pl, h_pl, w_pl, w_grad = _mesh_layout(p, u, cfg)
    S = u.shape[1]

    def core(ul, gl, *ws):
        y, h = _core(_local(ws), ul, gl, cfg)
        return y, h[:, -1], ul[:, S - keep:].float()

    y, h, conv = sharding.region(
        core, (u, g, *(getattr(p, n) for n in _LOCAL)),
        (c_pl, c_pl, *w_pl), (c_pl, h_pl, c_pl), (c_pl, c_pl, *w_grad))
    return matmul(y, p.w_out), h, conv


def rglru(p: RGLRU, x, positions, cfg: ModelConfig):
    """Forward. x: (B, S, d)."""
    if on_mesh(p.w_x):
        return _rglru_mesh(p, x, cfg)[0]
    return _rglru(p, x, cfg)[0]


def rglru_prefill(p: RGLRU, x, positions, cfg: ModelConfig, cache_len: int):
    """Forward + the final state for decode: h (B, dr) and the last cw - 1
    pre-conv inputs (B, cw - 1, dr), f32. A prompt shorter than cw - 1
    tokens raises (the reference emits a conv window of the wrong length,
    which fails at the first decode step)."""
    keep = cfg.conv_width - 1
    if x.shape[1] < keep:
        raise ValueError(f"RG-LRU prefill needs at least conv_width - 1 = {keep} "
                         f"tokens to fill the conv window; got {x.shape[1]}")
    if on_mesh(p.w_x):
        out, h, conv = _rglru_mesh(p, x, cfg)
        return out, {"h": sharding.constrain(h, "batch", "tp"),
                     "conv": sharding.constrain(conv, "batch", None, "tp")}
    out, u, h = _rglru(p, x, cfg)
    return out, {"h": h[:, -1].float(), "conv": u[:, x.shape[1] - keep:].float()}


def rglru_decode(p: RGLRU, x, cache: dict, pos: int, cfg: ModelConfig):
    """Single-token decode. x: (B, 1, d); cache: {h: (B, dr), conv: (B,
    cw - 1, dr)}, f32, updated in place and returned."""
    u, g = _branches(p, x)
    if on_mesh(p.w_x):
        c_pl, h_pl, w_pl, _ = _mesh_layout(p, u, cfg)
        y, h, window = sharding.region(
            lambda ul, gl, hc, cc, *ws: _step(_local(ws), ul, gl, hc, cc),
            (u, g, cache["h"], cache["conv"], *(getattr(p, n) for n in _LOCAL)),
            (c_pl, c_pl, h_pl, c_pl, *w_pl), (c_pl, h_pl, c_pl))
    else:
        y, h, window = _step(p, u, g, cache["h"], cache["conv"])
    cache["h"].copy_(sharding.constrain(h, "batch", "tp"))
    cache["conv"].copy_(sharding.constrain(window, "batch", None, "tp"))
    return matmul(y, p.w_out), cache


def _step(p, u, g, h, conv_in):
    """One decode step of the branches u, g (B, 1, dr) from the state h
    (B, dr) and the conv window (B, cw - 1, dr): (y (B, 1, dr) bf16, the
    new h, the new window)."""
    window = torch.cat([conv_in, u.float()], 1)  # (B, cw, dr), new tensor
    conv = (window * p.conv_w).sum(1) + p.conv_b
    a, b = _gates(p, conv)
    h = a * h + b
    return (h * g[:, 0]).to(COMPUTE_DTYPE)[:, None], h, window[:, 1:]


def rglru_cache_shape(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """{name: (shape, dtype)} of one layer's decode cache."""
    dr = cfg.d_rnn or cfg.d_model
    return {
        "h": ((batch, dr), PARAM_DTYPE),
        "conv": ((batch, cfg.conv_width - 1, dr), PARAM_DTYPE),
    }
