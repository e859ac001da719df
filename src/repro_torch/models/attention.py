"""Attention mixers: GQA (optional sliding window, QKV bias) and MLA
(DeepSeek multi-head latent attention), with chunked causal attention for
prefill and forward, and cache-based single-token decode. A port of the
reference's `models/attention.py`.

Chunked causal attention never materialises the S x S score matrix: the
(q-chunk, kv-chunk) pairs are enumerated statically and walked with
online-softmax state (`flash_vjp._scan`). With `packing=True` only the
lower triangle (and, under a sliding window, only chunks overlapping the
window) is visited; `packing=False` is the full masked grid.

The reference repeats K/V to the full head count on a mesh
(`_constrained_qkv`, `gqa_broadcast`) so that attention shards on the
q-head axis; on one card the grouped form (KV heads x G queries a head)
computes the same numbers without the copy, and is what the port keeps.

Weights are held as 2-D bf16 tensors: wq (d, H·hd), wk and wv (d, KV·hd),
wo (H·hd, d), the biases (H·hd,) and (KV·hd,) — the reference's (d, H,
hd) and (H, hd, d) arrays with their head axes merged; MLA's the same way
(`MLA`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .flash_vjp import NEG_INF, _scan, flash_causal
from .layers import (COMPUTE_DTYPE, apply_rope, fanin, matmul, rms_norm,
                     stored)


# ===================================================================== #
# chunked causal core
# ===================================================================== #
def chunked_causal(
    q: torch.Tensor,  # (B, S, KV, G, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, hdv)
    *,
    chunk: int,
    window: int = 0,
    packing: bool = True,
    scale: Optional[float] = None,
    flash: bool = False,
) -> torch.Tensor:  # (B, S, KV, G, hdv)
    S = q.shape[1]
    hd = q.shape[-1]
    C = min(chunk, S)
    S_real = S
    if S % C:  # pad to a chunk multiple; the causal mask hides padded keys
        pad = C - S % C
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = scale or hd ** -0.5
    if flash:
        return flash_causal(q, k, v, C, window, packing, scale)[:, :S_real]
    out, _, _ = _scan(q, k, v, C, window, packing, scale, True)
    return out.to(COMPUTE_DTYPE)[:, :S_real]


# ===================================================================== #
# GQA
# ===================================================================== #
class Attention(nn.Module):
    """The GQA mixer's parameters. With a `generator` they are drawn as
    the reference's `init_attn` draws them (fan-in normals, zero biases);
    without one they are left empty, to be loaded (or counted, on the
    meta device)."""

    def __init__(self, cfg: ModelConfig, device, generator=None,
                 param_dtype=COMPUTE_DTYPE):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
        shapes = {
            "wq": ((d, h, hd), 0), "wk": ((d, kv, hd), 0),
            "wv": ((d, kv, hd), 0), "wo": ((h, hd, d), 1),
        }
        for name, (shape, fan_axis) in shapes.items():
            if generator is None:
                t = torch.empty(shape, dtype=param_dtype, device=device)
            else:
                t = fanin(shape, generator, device, fan_axis=fan_axis,
                          dtype=param_dtype)
            rows = d if name != "wo" else h * hd
            self.register_parameter(
                name, nn.Parameter(t.reshape(rows, -1), requires_grad=False))
        if cfg.qkv_bias:
            for name, heads in (("bq", h), ("bk", kv), ("bv", kv)):
                t = torch.zeros(heads * hd, dtype=param_dtype, device=device)
                self.register_parameter(name, nn.Parameter(t, requires_grad=False))


def init_attn(cfg: ModelConfig, device, generator=None,
              param_dtype=COMPUTE_DTYPE) -> Attention:
    return Attention(cfg, device, generator, param_dtype)


def _qkv(p: Attention, x, positions, cfg: ModelConfig):
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    B, S = x.shape[:2]
    q = matmul(x, p.wq).view(B, S, h, hd)
    k = matmul(x, p.wk).view(B, S, kv, hd)
    v = matmul(x, p.wv).view(B, S, kv, hd)
    if cfg.qkv_bias:
        q = q + p.bq.view(h, hd).to(q.dtype)
        k = k + p.bk.view(kv, hd).to(k.dtype)
        v = v + p.bv.view(kv, hd).to(v.dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = q.reshape(B, S, kv, h // kv, hd)
    return q, k, v


def _attend(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    B, S = q.shape[:2]
    o = chunked_causal(
        q, k, v,
        chunk=cfg.attn_chunk, window=cfg.window, packing=cfg.causal_packing,
        flash=cfg.flash_backward,
    )
    return o.reshape(B, S, cfg.n_heads * cfg.hd)


def attn(p: Attention, x, positions, cfg: ModelConfig):
    """Forward GQA. x: (B, S, d), positions: (B, S)."""
    q, k, v = _qkv(p, x, positions, cfg)
    return matmul(_attend(q, k, v, cfg), p.wo)


def attn_decode(p: Attention, x, cache: dict, pos: int, cfg: ModelConfig):
    """Single-token decode. x: (B, 1, d); cache: {k, v: (B, T, KV, hd)};
    pos: the new token's position (the same for every sequence). For
    sliding-window configs the cache is a rolling buffer of length
    min(window, T) and writes go to pos % T; for full attention to
    min(pos, T - 1). The reference returns a new cache; the port writes
    the new entries into `cache` in place and returns it."""
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    B = x.shape[0]
    T = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, x, positions, cfg)
    slot = pos % T if cfg.window else min(pos, T - 1)
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]
    idx = torch.arange(T, device=x.device)
    valid = (idx <= pos) | (pos >= T)  # rolling buffer fully valid once warm
    f32 = torch.float32
    qf = q[:, 0].to(COMPUTE_DTYPE).to(f32)                   # (B, KV, G, hd)
    kf = k.to(COMPUTE_DTYPE).to(f32).permute(0, 2, 3, 1)      # (B, KV, hd, T)
    s = torch.matmul(qf, kf) * hd ** -0.5                     # (B, KV, G, T)
    s = torch.where(valid, s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    vf = v.to(COMPUTE_DTYPE).to(f32).permute(0, 2, 1, 3)      # (B, KV, T, hd)
    o = torch.matmul(probs.to(COMPUTE_DTYPE).to(f32), vf).to(COMPUTE_DTYPE)
    y = matmul(o.reshape(B, 1, h * hd), p.wo)
    return y, cache


def attn_cache_shape(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """{name: (shape, dtype)} of one layer's decode cache."""
    T = min(cfg.window, seq) if cfg.window else seq
    sh = (batch, T, cfg.n_kv, cfg.hd)
    return {"k": (sh, COMPUTE_DTYPE), "v": (sh, COMPUTE_DTYPE)}


# ===================================================================== #
# prefill (forward + cache emission)
# ===================================================================== #
def _pack_kv(t_new: torch.Tensor, cache_len: int, window: int) -> torch.Tensor:
    """Pack (B, S, ...) per-position tensors into a decode cache of length
    T = cache_len (full attention: left-aligned, zero-padded) or
    T = min(window, cache_len) (rolling buffer, slot = pos % T)."""
    B, S = t_new.shape[:2]
    if window:
        T = min(window, cache_len)
        keep = min(T, S)
        tail = t_new[:, S - keep:]
        pos = torch.arange(S - keep, S, device=t_new.device) % T
        buf = torch.zeros((B, T, *t_new.shape[2:]), dtype=t_new.dtype,
                          device=t_new.device)
        buf[:, pos] = tail
        return buf
    T = cache_len
    if S >= T:
        return t_new[:, :T].contiguous()
    pad = torch.zeros((B, T - S, *t_new.shape[2:]), dtype=t_new.dtype,
                      device=t_new.device)
    return torch.cat([t_new, pad], dim=1)


def attn_prefill(p: Attention, x, positions, cfg: ModelConfig, cache_len: int):
    q, k, v = _qkv(p, x, positions, cfg)
    y = matmul(_attend(q, k, v, cfg), p.wo)
    cache = {
        "k": _pack_kv(k, cache_len, cfg.window),
        "v": _pack_kv(v, cache_len, cfg.window),
    }
    return y, cache


# ===================================================================== #
# MLA (DeepSeek-V2)
# ===================================================================== #
class MLA(nn.Module):
    """The MLA mixer's parameters by the reference's names, head axes
    merged: w_dkv (d, kv_lora), norm_kv (kv_lora,) f32, w_uk (kv_lora,
    H·qk_nope), w_uv (kv_lora, H·v_head), w_kr (d, qk_rope), w_q (d,
    H·(qk_nope + qk_rope)), w_o (H·v_head, d). All bf16 but norm_kv and
    w_uv: the absorbed decode multiplies by the unrounded f32 w_uv (as
    the reference does), the prefill by its bf16 rounding."""

    def __init__(self, cfg: ModelConfig, device, generator=None,
                 param_dtype=COMPUTE_DTYPE):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        lora, qn, qr, vh = cfg.kv_lora, cfg.qk_nope, cfg.qk_rope, cfg.v_head
        f32 = torch.float32
        shapes = {
            "w_dkv": ((d, lora), 0, COMPUTE_DTYPE),
            "w_uk": ((lora, h, qn), 0, COMPUTE_DTYPE),
            "w_uv": ((lora, h, vh), 0, f32),
            "w_kr": ((d, qr), 0, COMPUTE_DTYPE),
            "w_q": ((d, h, qn + qr), 0, COMPUTE_DTYPE),
            "w_o": ((h, vh, d), 1, COMPUTE_DTYPE),
        }
        for name, (shape, fan_axis, dtype) in shapes.items():
            dtype = stored(dtype, param_dtype)
            if generator is None:
                t = torch.empty(shape, dtype=dtype, device=device)
            else:
                t = fanin(shape, generator, device, fan_axis=fan_axis, dtype=dtype)
            rows = shape[0] if name != "w_o" else h * vh
            self.register_parameter(
                name, nn.Parameter(t.reshape(rows, -1), requires_grad=False))
        self.norm_kv = nn.Parameter(torch.ones(lora, dtype=f32, device=device),
                                    requires_grad=False)


def _latent(p: MLA, x, positions, cfg: ModelConfig):
    """The cached latents of x: the normed c_kv (B, S, kv_lora) and the
    roped shared key k_rope (B, S, qk_rope), bf16."""
    ckv = rms_norm(matmul(x, p.w_dkv), p.norm_kv, cfg.norm_eps)
    kr = apply_rope(matmul(x, p.w_kr)[:, :, None, :], positions, cfg.rope_theta)
    return ckv, kr[:, :, 0, :]


def _queries(p: MLA, x, positions, cfg: ModelConfig):
    """(q_nope (B, S, H, qk_nope), roped q_rope (B, S, H, qk_rope)), bf16."""
    B, S = x.shape[:2]
    qn = cfg.qk_nope
    q = matmul(x, p.w_q).view(B, S, cfg.n_heads, qn + cfg.qk_rope)
    return q[..., :qn], apply_rope(q[..., qn:], positions, cfg.rope_theta)


def _mla(p: MLA, x, positions, cfg: ModelConfig):
    """The non-absorbed MLA forward. Returns (y, c_kv, k_rope)."""
    B, S = x.shape[:2]
    h, qn, qr, vh = cfg.n_heads, cfg.qk_nope, cfg.qk_rope, cfg.v_head
    q_nope, q_rope = _queries(p, x, positions, cfg)
    ckv, kr = _latent(p, x, positions, cfg)
    k_nope = matmul(ckv, p.w_uk).view(B, S, h, qn)
    v = matmul(ckv, p.w_uv).view(B, S, h, vh)
    k_rope = kr[:, :, None, :].expand(B, S, h, qr)
    q_cat = torch.cat([q_nope, q_rope], -1)[:, :, :, None, :]  # (B, S, H, 1, hd)
    k_cat = torch.cat([k_nope, k_rope], -1)
    o = chunked_causal(
        q_cat, k_cat, v,
        chunk=cfg.attn_chunk, packing=cfg.causal_packing,
        scale=(qn + qr) ** -0.5, flash=cfg.flash_backward,
    )
    return matmul(o.reshape(B, S, h * vh), p.w_o), ckv, kr


def mla(p: MLA, x, positions, cfg: ModelConfig):
    """Forward MLA (the non-absorbed form). x: (B, S, d)."""
    return _mla(p, x, positions, cfg)[0]


def mla_decode(p: MLA, x, cache: dict, pos: int, cfg: ModelConfig):
    """Absorbed-form single-token decode: the cache holds only c_kv and
    k_rope, and W_uk / W_uv fold into the query and the output. The chain
    from q_abs to the output stays f32 (q_abs multiplies bf16 operands
    with f32 sums; the output multiplies by the f32 w_uv), as in the
    reference, whose comment gives the reason: a bf16 round trip in the
    kv_lora basis perturbs decode enough to flip the MoE router's top-k.
    The new entries are written into `cache` in place (slot min(pos,
    T - 1)), which is returned."""
    B = x.shape[0]
    h, qn, qr, vh = cfg.n_heads, cfg.qk_nope, cfg.qk_rope, cfg.v_head
    lora = cfg.kv_lora
    T = cache["ckv"].shape[1]
    f32 = torch.float32
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(p, x, positions, cfg)
    ckv_new, kr_new = _latent(p, x, positions, cfg)
    slot = min(pos, T - 1)
    cache["ckv"][:, slot] = ckv_new[:, 0].to(cache["ckv"].dtype)
    cache["kr"][:, slot] = kr_new[:, 0].to(cache["kr"].dtype)
    ckv = cache["ckv"].float()                                   # (B, T, lora)
    kr = cache["kr"].float()                                     # (B, T, qr)
    w_uk = p.w_uk.view(lora, h, qn).permute(1, 2, 0).float()      # (H, qn, lora)
    q_abs = torch.matmul(q_nope[:, 0].float().transpose(0, 1), w_uk)  # (H, B, lora)
    q_abs = q_abs.transpose(0, 1)                                # (B, H, lora)
    s = torch.matmul(q_abs, ckv.transpose(1, 2))                 # (B, H, T)
    s = s + torch.matmul(q_rope[:, 0].float(), kr.transpose(1, 2))
    s = s * (qn + qr) ** -0.5
    valid = torch.arange(T, device=x.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    ctx = torch.matmul(probs, ckv)                               # (B, H, lora)
    w_uv = p.w_uv.view(lora, h, vh).transpose(0, 1)              # (H, lora, vh)
    o = torch.matmul(ctx.transpose(0, 1), w_uv).transpose(0, 1)  # (B, H, vh)
    y = matmul(o.to(COMPUTE_DTYPE).reshape(B, 1, h * vh), p.w_o)
    return y, cache


def mla_cache_shape(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """{name: (shape, dtype)} of one layer's decode cache."""
    return {
        "ckv": ((batch, seq, cfg.kv_lora), COMPUTE_DTYPE),
        "kr": ((batch, seq, cfg.qk_rope), COMPUTE_DTYPE),
    }


def mla_prefill(p: MLA, x, positions, cfg: ModelConfig, cache_len: int):
    y, ckv, kr = _mla(p, x, positions, cfg)
    cache = {"ckv": _pack_kv(ckv, cache_len, 0), "kr": _pack_kv(kr, cache_len, 0)}
    return y, cache
