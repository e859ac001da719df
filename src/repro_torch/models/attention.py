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
On a mesh the port takes the reference's branch (`_attn_mesh`): batch on
data, q heads on model, each rank repeating K/V to its own heads where
the KV heads do not split as the q heads do; the walk then needs no
collective. Decode attends over the cache's time shards and reduces
across them (`_attn_decode_mesh`).

Weights are held as 2-D bf16 tensors on one card: wq (d, H·hd), wk and
wv (d, KV·hd), wo (H·hd, d), the biases (H·hd,) and (KV·hd,) — the
reference's (d, H, hd) and (H, hd, d) arrays with their head axes
merged; MLA's the same way (`MLA`). On a mesh they are the reference's
arrays (`sharding.shard_model`), used through `_heads` / `_merge_heads`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import Partial, Replicate, Shard

from . import sharding
from .config import ModelConfig
from .flash_vjp import NEG_INF, _scan, flash_causal
from .layers import (COMPUTE_DTYPE, apply_rope, fanin, matmul, rms_norm,
                     stored)
from .sharding import on_mesh


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


def _heads(x, w, n: int, hd: int):
    """x (B, S, d) times a weight of n heads of hd -> (B, S, n, hd): the
    port's merged (d, n·hd) weight on one card, the reference's (d, n, hd)
    on a mesh."""
    if on_mesh(w):
        return sharding.einsum("bsd,dhk->bshk", x, w)
    B, S = x.shape[:2]
    return matmul(x, w).view(B, S, n, hd)


def _merge_heads(o, w):
    """o (B, S, n, hd) times the output weight -> (B, S, d)."""
    if on_mesh(w):
        return sharding.einsum("bshk,hkd->bsd", o, w)
    B, S = o.shape[:2]
    return matmul(o.reshape(B, S, -1), w)


def _project(p: Attention, x, cfg: ModelConfig):
    """q (B, S, H, hd), k and v (B, S, KV, hd) with their biases, before
    RoPE."""
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = _heads(x, p.wq, h, hd)
    k = _heads(x, p.wk, kv, hd)
    v = _heads(x, p.wv, kv, hd)
    if cfg.qkv_bias:
        q = q + p.bq.view(h, hd).to(q.dtype)
        k = k + p.bk.view(kv, hd).to(k.dtype)
        v = v + p.bv.view(kv, hd).to(v.dtype)
    return q, k, v


def _qkv(p: Attention, x, positions, cfg: ModelConfig):
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    B, S = x.shape[:2]
    q, k, v = _project(p, x, cfg)
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
    if on_mesh(p.wq):
        return _attn_mesh(p, x, positions, cfg)[0]
    q, k, v = _qkv(p, x, positions, cfg)
    return matmul(_attend(q, k, v, cfg), p.wo)


# ===================================================================== #
# on a mesh
# ===================================================================== #
def _head_placements(q, k, cfg: ModelConfig):
    """The reference's `gqa_broadcast` constraints of the attention walk:
    (q's placements (batch, heads), k's and v's, their gradients', and
    whether each rank repeats K/V to its own q heads). K/V keep their
    heads sharded where the KV heads split as the q heads do; otherwise
    every rank holds them whole, takes its q heads' KV heads, and their
    gradient is partial across the heads' shards."""
    rules = sharding.current_rules()
    q_pl = rules.placements(q.shape, ("batch", None, "heads", None))
    k_pl = rules.placements(k.shape, ("batch", None, "heads", None))
    heads = [pl.is_shard(2) for pl in q_pl]
    if [pl.is_shard(2) for pl in k_pl] == heads:
        return q_pl, k_pl, k_pl, False
    row = sharding.row_placements_of(q_pl)
    grad = [Partial() if hs else r for hs, r in zip(heads, row)]
    return q_pl, row, grad, any(heads)


def _walk_local(q, k, v, pos, cfg: ModelConfig, mesh, repeat: bool,
                window: int):
    """The attention walk on one rank's shards: RoPE, then the grouped
    walk (or, where the rank repeats K/V, the broadcast one). q (B, S, Hl,
    hd), k and v (B, S, KVl, hd). Returns (o (B, S, Hl, hd), roped k)."""
    B, S, Hl, hd = q.shape
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    kr = k
    if repeat:
        g = cfg.n_heads // cfg.n_kv
        first = sharding.coordinate(mesh, "model") * Hl
        idx = (torch.arange(Hl, device=q.device) + first) // g
        k, v = k[:, :, idx], v[:, :, idx]
        q5 = q[:, :, :, None, :]
    else:
        kvl = k.shape[2]
        q5 = q.reshape(B, S, kvl, Hl // kvl, hd)
    o = chunked_causal(q5, k, v, chunk=cfg.attn_chunk, window=window,
                       packing=cfg.causal_packing, flash=cfg.flash_backward)
    return o.reshape(B, S, Hl, hd), kr


def _attn_mesh(p: Attention, x, positions, cfg: ModelConfig,
               cache_len: int = 0):
    """GQA on a mesh: the projections through `sharding.einsum`, the walk
    on local shards with batch on data and heads on model, which needs no
    collective. With `cache_len` also the decode cache, placed by the
    reference's cache spec. Returns (y, cache or None)."""
    q, k, v = _project(p, x, cfg)
    mesh = q.device_mesh
    q_pl, k_pl, k_grad, repeat = _head_placements(q, k, cfg)
    row = sharding.row_placements_of(q_pl)

    def walk(ql, kl, vl, pl):
        return _walk_local(ql, kl, vl, pl, cfg, mesh, repeat, cfg.window)

    o, kr = sharding.region(walk, (q, k, v, positions), (q_pl, k_pl, k_pl, row),
                            (q_pl, k_pl), (q_pl, k_grad, k_grad, row))
    y = _merge_heads(o, p.wo)
    if not cache_len:
        return y, None
    cache = {}
    for name, t in (("k", kr), ("v", v.redistribute(mesh, k_pl))):
        packed = sharding.region(lambda tl: _pack_kv(tl, cache_len, cfg.window),
                                 (t,), (k_pl,), k_pl)
        cache[name] = sharding.constrain(packed, "batch", "seq", "heads", "hd")
    return y, cache


def _time_shards(c_pl: list):
    """The mesh dims that shard a cache's time axis (dim 1)."""
    return [m for m, pl in enumerate(c_pl) if pl.is_shard(1)]


def _first_slot(mesh, dims, Tl: int) -> int:
    """The first cache slot of this rank's time shard of Tl slots."""
    return sum(sharding.coordinate(mesh, mesh.mesh_dim_names[m])
               for m in dims) * Tl


def _attn_decode_mesh(p: Attention, x, cache: dict, pos: int,
                      cfg: ModelConfig):
    """Single-token GQA decode on a mesh. The cache is sharded as the
    reference's spec places it — batch on data, time on model — and each
    rank attends over its own slots (`_decode_attend`): the row max, the
    softmax sum and the weighted values are reduced across the time
    shards (flash-decoding), and the new entry is written by the rank
    that holds its slot."""
    q, k_new, v_new = _project(p, x, cfg)
    mesh = q.device_mesh
    c_pl = list(cache["k"].placements)
    row = [pl if pl.is_shard(0) else Replicate() for pl in c_pl]
    dims = _time_shards(c_pl)
    qo_pl = list(row)
    for m, pl in enumerate(c_pl):  # KV heads sharded: q's groups follow them
        if pl.is_shard(2):
            qo_pl[m] = Shard(2)
    T = cache["k"].shape[1]

    def step(ql, kn, vn, kc, vc):
        positions = torch.full((ql.shape[0], 1), pos, dtype=torch.int32,
                               device=ql.device)
        ql = apply_rope(ql, positions, cfg.rope_theta)
        kn = apply_rope(kn, positions, cfg.rope_theta)
        return _decode_attend(ql, kn, vn, kc, vc, pos, T, cfg,
                              _first_slot(mesh, dims, kc.shape[1]),
                              _reducer(mesh, dims))

    o = sharding.region(step, (q, k_new, v_new, cache["k"], cache["v"]),
                        (qo_pl, qo_pl, qo_pl, c_pl, c_pl), qo_pl)
    return _merge_heads(o, p.wo), cache


def _reducer(mesh, dims):
    """None where no mesh dim shards the time axis (the rank holds the
    whole cache), else `t, op` -> `t` reduced across those dims."""
    if not dims:
        return None
    return lambda t, op: sharding.seq_reduce(t, op, mesh, dims)


def _softmax(s, reduce):
    """softmax over the last axis of the slots `s`, whose other slots
    other ranks hold where `reduce` is given."""
    if reduce is None:
        return torch.softmax(s, dim=-1)
    m = reduce(s.amax(-1), "max")
    e = torch.exp(s - m[..., None])
    return e / reduce(e.sum(-1), "sum")[..., None]


def _decode_attend(q, k_new, v_new, kc, vc, pos: int, T: int,
                   cfg: ModelConfig, first: int = 0, reduce=None):
    """The decode step's attention over cache slots first .. first + Tl
    of T (the whole cache on one card; a rank's time shard on a mesh):
    the roped new entries k_new, v_new (B, 1, KV, hd) are written into kc,
    vc (B, Tl, KV, hd) in place where their slot lies there, and q (B, 1,
    H, hd, roped; or grouped (B, 1, KV, G, hd)) attends with f32 scores.
    `reduce` combines the softmax and the weighted values across the
    time shards. Returns o (B, 1, H, hd) bf16."""
    B, Tl, kvl, hd = kc.shape
    slot = pos % T if cfg.window else min(pos, T - 1)
    if first <= slot < first + Tl:
        kc[:, slot - first] = k_new[:, 0].to(kc.dtype)
        vc[:, slot - first] = v_new[:, 0].to(vc.dtype)
    idx = first + torch.arange(Tl, device=kc.device)
    valid = (idx <= pos) | (pos >= T)  # rolling buffer fully valid once warm
    f32 = torch.float32
    qf = q[:, 0].reshape(B, kvl, -1, hd).to(COMPUTE_DTYPE).to(f32)  # (B, KV, G, hd)
    kf = kc.to(COMPUTE_DTYPE).to(f32).permute(0, 2, 3, 1)        # (B, KV, hd, Tl)
    s = torch.matmul(qf, kf) * hd ** -0.5                         # (B, KV, G, Tl)
    s = torch.where(valid, s, NEG_INF)
    probs = _softmax(s, reduce)
    vf = vc.to(COMPUTE_DTYPE).to(f32).permute(0, 2, 1, 3)         # (B, KV, Tl, hd)
    o = torch.matmul(probs.to(COMPUTE_DTYPE).to(f32), vf)
    if reduce is not None:
        o = reduce(o, "sum")
    return o.to(COMPUTE_DTYPE).reshape(B, 1, -1, hd)


def attn_decode(p: Attention, x, cache: dict, pos: int, cfg: ModelConfig):
    """Single-token decode. x: (B, 1, d); cache: {k, v: (B, T, KV, hd)};
    pos: the new token's position (the same for every sequence). For
    sliding-window configs the cache is a rolling buffer of length
    min(window, T) and writes go to pos % T; for full attention to
    min(pos, T - 1). The reference returns a new cache; the port writes
    the new entries into `cache` in place and returns it."""
    if on_mesh(p.wq):
        return _attn_decode_mesh(p, x, cache, pos, cfg)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, x, positions, cfg)
    o = _decode_attend(q, k_new, v_new, cache["k"], cache["v"], pos,
                       cache["k"].shape[1], cfg)
    return matmul(o.reshape(B, 1, -1), p.wo), cache


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
    if on_mesh(p.wq):
        return _attn_mesh(p, x, positions, cfg, cache_len)
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
    if on_mesh(p.w_q):
        return _mla_mesh(p, x, positions, cfg)[0]
    return _mla(p, x, positions, cfg)[0]


def _mla_mesh(p: MLA, x, positions, cfg: ModelConfig, cache_len: int = 0):
    """The non-absorbed MLA on a mesh: the products through
    `sharding.einsum`, the walk on local shards (batch on data, heads on
    model; the shared roped key is held whole and its gradient is partial
    across the heads' shards). Returns (y, cache or None)."""
    h, qn, qr, vh = cfg.n_heads, cfg.qk_nope, cfg.qk_rope, cfg.v_head
    q = _heads(x, p.w_q, h, qn + qr)
    ckv = rms_norm(matmul(x, p.w_dkv), p.norm_kv, cfg.norm_eps)
    k_nope = sharding.einsum("bsl,lhk->bshk", ckv, p.w_uk)
    v = sharding.einsum("bsl,lhk->bshk", ckv, p.w_uv)
    kr = matmul(x, p.w_kr)
    mesh = q.device_mesh
    rules = sharding.current_rules()
    q_pl = rules.placements(q.shape, ("batch", None, "heads", None))
    row = sharding.row_placements_of(q_pl)
    kr_grad = [Partial() if pl.is_shard(2) else r for pl, r in zip(q_pl, row)]

    def walk(ql, kn, vl, krl, pl):
        B, S, Hl, _ = ql.shape
        q_rope = apply_rope(ql[..., qn:], pl, cfg.rope_theta)
        k_r = apply_rope(krl[:, :, None, :], pl, cfg.rope_theta)
        q_cat = torch.cat([ql[..., :qn], q_rope], -1)[:, :, :, None, :]
        k_cat = torch.cat([kn, k_r.expand(B, S, Hl, qr)], -1)
        o = chunked_causal(q_cat, k_cat, vl, chunk=cfg.attn_chunk,
                           packing=cfg.causal_packing, scale=(qn + qr) ** -0.5,
                           flash=cfg.flash_backward)
        return o.reshape(B, S, Hl, vh), k_r[:, :, 0, :]

    o, kr_roped = sharding.region(
        walk, (q, k_nope, v, kr, positions), (q_pl, q_pl, q_pl, row, row),
        (q_pl, row), (q_pl, q_pl, q_pl, kr_grad, row))
    y = _merge_heads(o, p.w_o)
    if not cache_len:
        return y, None
    cache = {}
    for name, t in (("ckv", ckv), ("kr", kr_roped)):
        packed = sharding.region(lambda tl: _pack_kv(tl, cache_len, 0),
                                 (t,), (row,), row)
        cache[name] = sharding.constrain(packed, "batch", "seq", None)
    return y, cache


def _mla_decode_mesh(p: MLA, x, cache: dict, pos: int, cfg: ModelConfig):
    """The absorbed MLA decode on a mesh: q_abs and the output's w_uv
    product through `sharding.einsum` in f32 (heads on model), the cache
    part (`_mla_attend`) on local shards of the time axis, reduced across
    them as in `_attn_decode_mesh`."""
    h, qn, qr = cfg.n_heads, cfg.qk_nope, cfg.qk_rope
    q = _heads(x, p.w_q, h, qn + qr)
    ckv_new = rms_norm(matmul(x, p.w_dkv), p.norm_kv, cfg.norm_eps)
    kr_new = matmul(x, p.w_kr)
    q_abs = sharding.einsum("bhk,lhk->bhl", q[:, 0, :, :qn], p.w_uk, f32=True)
    q_rope = q[..., qn:]
    mesh = q.device_mesh
    c_pl = list(cache["ckv"].placements)
    row = [pl if pl.is_shard(0) else Replicate() for pl in c_pl]
    dims = _time_shards(c_pl)
    T = cache["ckv"].shape[1]

    def step(qa, qrp, cn, krn, cc, kc):
        positions = torch.full((qa.shape[0], 1), pos, dtype=torch.int32,
                               device=qa.device)
        q_r = apply_rope(qrp, positions, cfg.rope_theta)
        k_r = apply_rope(krn[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
        return _mla_attend(qa, q_r, cn, k_r, cc, kc, pos, T, cfg,
                           _first_slot(mesh, dims, cc.shape[1]),
                           _reducer(mesh, dims))

    ctx = sharding.region(step, (q_abs, q_rope, ckv_new, kr_new, cache["ckv"],
                                 cache["kr"]),
                          (row, row, row, row, c_pl, c_pl), row)
    o = sharding.einsum("bhl,lhv->bhv", ctx, p.w_uv, f32=True)
    return _merge_heads(o.to(COMPUTE_DTYPE)[:, None], p.w_o), cache


def _mla_attend(q_abs, q_rope, ckv_new, kr_new, cc, kc, pos: int, T: int,
                cfg: ModelConfig, first: int = 0, reduce=None):
    """The absorbed decode's attention over cache slots first .. first +
    Tl of T (as `_decode_attend`): the new latents ckv_new (B, 1, kv_lora)
    and roped kr_new (B, 1, qk_rope) written into cc, kc in place where
    their slot min(pos, T - 1) lies there; q_abs (B, H, kv_lora) f32 and
    the roped q_rope (B, 1, H, qk_rope) score the slots in f32. Returns
    the f32 context (B, H, kv_lora)."""
    Tl = cc.shape[1]
    slot = min(pos, T - 1)
    if first <= slot < first + Tl:
        cc[:, slot - first] = ckv_new[:, 0].to(cc.dtype)
        kc[:, slot - first] = kr_new[:, 0].to(kc.dtype)
    ckv, kr = cc.float(), kc.float()                             # (B, Tl, ·)
    s = torch.matmul(q_abs, ckv.transpose(1, 2))                 # (B, H, Tl)
    s = s + torch.matmul(q_rope[:, 0].float(), kr.transpose(1, 2))
    s = s * (cfg.qk_nope + cfg.qk_rope) ** -0.5
    valid = first + torch.arange(Tl, device=cc.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    ctx = torch.matmul(_softmax(s, reduce), ckv)                 # (B, H, lora)
    return ctx if reduce is None else reduce(ctx, "sum")


def mla_decode(p: MLA, x, cache: dict, pos: int, cfg: ModelConfig):
    """Absorbed-form single-token decode: the cache holds only c_kv and
    k_rope, and W_uk / W_uv fold into the query and the output. The chain
    from q_abs to the output stays f32 (q_abs multiplies bf16 operands
    with f32 sums; the output multiplies by the f32 w_uv), as in the
    reference, whose comment gives the reason: a bf16 round trip in the
    kv_lora basis perturbs decode enough to flip the MoE router's top-k.
    The new entries are written into `cache` in place (slot min(pos,
    T - 1)), which is returned."""
    if on_mesh(p.w_q):
        return _mla_decode_mesh(p, x, cache, pos, cfg)
    B = x.shape[0]
    h, qn, vh = cfg.n_heads, cfg.qk_nope, cfg.v_head
    lora = cfg.kv_lora
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _queries(p, x, positions, cfg)
    ckv_new, kr_new = _latent(p, x, positions, cfg)
    w_uk = p.w_uk.view(lora, h, qn).permute(1, 2, 0).float()      # (H, qn, lora)
    q_abs = torch.matmul(q_nope[:, 0].float().transpose(0, 1), w_uk)  # (H, B, lora)
    ctx = _mla_attend(q_abs.transpose(0, 1), q_rope, ckv_new, kr_new,
                      cache["ckv"], cache["kr"], pos, cache["ckv"].shape[1], cfg)
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
    if on_mesh(p.w_q):
        return _mla_mesh(p, x, positions, cfg, cache_len)
    y, ckv, kr = _mla(p, x, positions, cfg)
    cache = {"ckv": _pack_kv(ckv, cache_len, 0), "kr": _pack_kv(kr, cache_len, 0)}
    return y, cache
