"""xLSTM blocks (arXiv:2405.04517): the mLSTM (matrix memory) and the
sLSTM (scalar memory with recurrent gate connections). A port of the
reference's `models/xlstm.py`.

The mLSTM runs in chunkwise-parallel form: within a chunk a masked
quadratic (like attention over the chunk), across chunks the (dh × dh)
matrix memory carried by a loop over the chunks; decode is the O(1)
recurrent update of that memory. The sLSTM is sequential in time
(recurrent connections through h_{t-1}) and runs as a loop over the
time steps.

Gate stabilisation as in the reference: input gates are exp of the
pre-activation clamped at I_CLAMP; forget gates are sigmoids in log
space (logsigmoid <= 0), so every decay product stays in [0, 1].

Weights keep the dtype of the reference's use of them: the projections
that go through bf16 products (mLSTM w_up, wq, wk, wv, w_down; sLSTM
w_ffn1, w_ffn2) are stored bf16; the gate weights that enter f32
products (mLSTM w_i, w_f; sLSTM w_{z,i,f,o} and the recurrent r_{z,i,f,o}),
every bias and the mLSTM's norm stay f32.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate, Shard

from . import sharding
from .config import ModelConfig
from .layers import COMPUTE_DTYPE, PARAM_DTYPE, matmul, register_params, rms_norm

I_CLAMP = 10.0
MLSTM_PF = 2       # mLSTM up-projection factor
SLSTM_PF = 4 / 3   # sLSTM post-FFN factor
MLSTM_CHUNK = 256  # the chunk of the chunkwise-parallel form
GATES = ("z", "i", "f", "o")


# ===================================================================== #
# mLSTM
# ===================================================================== #
class MLSTM(nn.Module):
    """The mLSTM block's parameters by the reference's names: w_up (d,
    2·di), wq, wk, wv (di, di), w_down (di, d) bf16; w_i, w_f (di, nh),
    b_i, b_f (nh,) and norm (di,) f32 (di = 2·d)."""

    def __init__(self, cfg: ModelConfig, device, generator=None,
                 param_dtype=COMPUTE_DTYPE):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        di = MLSTM_PF * d
        bf16, f32 = COMPUTE_DTYPE, PARAM_DTYPE
        register_params(self, {
            "w_up": ((d, 2 * di), 0, bf16),
            "wq": ((di, di), 0, bf16),
            "wk": ((di, di), 0, bf16),
            "wv": ((di, di), 0, bf16),
            "w_i": ((di, nh), 0, f32),
            "w_f": ((di, nh), 0, f32),
            "b_i": ((nh,), None, f32, 0.0),
            "b_f": ((nh,), None, f32, 0.0),
            "norm": ((di,), None, f32, 1.0),
            "w_down": ((di, d), 0, bf16),
        }, device, generator, param_dtype)


def _mlstm_qkvif(p: MLSTM, x, cfg: ModelConfig):
    """q, k, v (B, S, nh, dh) bf16; the input and forget gates'
    pre-activations (B, S, nh) f32 (`_gate_acts`); the output gate's
    pre-activation z (B, S, di) bf16."""
    B, S, d = x.shape
    di = MLSTM_PF * d
    nh = cfg.n_heads
    dh = di // nh
    x_in, z = sharding.split(matmul(x, p.w_up), [di, di])
    x_in = sharding.constrain(x_in, "batch", None, "tp")
    q = matmul(x_in, p.wq).view(B, S, nh, dh)
    # the scale is rounded to bf16 first, as a Python float meets a bf16
    # array in the reference
    k = matmul(x_in, p.wk).view(B, S, nh, dh) * torch.tensor(
        dh ** -0.5, dtype=COMPUTE_DTYPE, device=x.device)
    v = matmul(x_in, p.wv).view(B, S, nh, dh)
    if sharding.on_mesh(p.w_i):
        i_pre = sharding.einsum("bse,eh->bsh", x_in, p.w_i, f32=True) + p.b_i
        f_pre = sharding.einsum("bse,eh->bsh", x_in, p.w_f, f32=True) + p.b_f
    else:
        xf = x_in.float()
        i_pre = torch.matmul(xf, p.w_i) + p.b_i
        f_pre = torch.matmul(xf, p.w_f) + p.b_f
    return q, k, v, i_pre, f_pre, z


def _gate_acts(i_pre, f_pre):
    """The input gate exp(min(i, I_CLAMP)) and the log forget gate
    logsigmoid(f), f32 (applied on each rank's rows on a mesh)."""
    return torch.exp(torch.clamp_max(i_pre, I_CLAMP)), F.logsigmoid(f_pre)


def _mlstm_out(p: MLSTM, h, z, cfg: ModelConfig):
    """The normed memory readout h (B, S, nh, dh), gated by silu(z)."""
    B, S = z.shape[:2]
    h = rms_norm(h.reshape(B, S, -1).to(COMPUTE_DTYPE), p.norm, cfg.norm_eps)
    y = h * F.silu(z.float()).to(h.dtype)
    return matmul(y, p.w_down)


def _mlstm_chunk_step(C0, n0, qc, kc, vc, ic, lfc):
    """One chunkwise-parallel step from the state (C0 (B, nh, dh, dh), n0
    (B, nh, dh)), f32, over a chunk's q, k, v (B, Cc, nh, dh) and gates
    (B, Cc, nh). Returns (C, n, y (B, Cc, nh, dh) bf16)."""
    Cc = qc.shape[1]
    qf, kf, vf = qc.float(), kc.float(), vc.float()
    lcum = torch.cumsum(lfc, 1)  # (B, Cc, nh) decay from the chunk's start
    # intra-chunk masked quadratic. Mask BEFORE exp: the masked (tau > t)
    # entries have rel > 0 and exp(rel) overflows; 0·inf is a NaN
    rel = lcum[:, :, None, :] - lcum[:, None, :, :]  # (B, t, tau, nh)
    causal = torch.ones(Cc, Cc, dtype=torch.bool, device=qc.device).tril()
    rel = torch.where(causal[None, :, :, None], rel, -1e9)
    w_in = torch.exp(rel) * ic[:, None]
    scores = torch.einsum("bthd,bshd->btsh", qf, kf) * w_in
    y_intra = torch.einsum("btsh,bshd->bthd", scores, vf)
    # normaliser: n_t = decay_t · n0 + sum_tau w_in[t, tau] · k_tau
    n_in = torch.einsum("btsh,bshd->bthd", w_in, kf)
    decay = torch.exp(lcum)
    y_inter = torch.einsum("bthd,bhde->bthe", qf * decay[..., None], C0)
    n_t = decay[..., None] * n0[:, None] + n_in
    y = y_intra + y_inter
    denom = torch.clamp_min(torch.einsum("bthd,bthd->bth", qf, n_t).abs(), 1.0)
    y = y / denom[..., None]
    # the chunk's state update
    total = lcum[:, -1]  # (B, nh) the chunk's whole decay
    wC = torch.exp(total[:, None] - lcum) * ic
    C = torch.exp(total)[..., None, None] * C0 + torch.einsum(
        "bshd,bshe->bhde", kf * wC[..., None], vf)
    n = torch.exp(total)[..., None] * n0 + torch.einsum("bsh,bshd->bhd", wC, kf)
    return C, n, y.to(COMPUTE_DTYPE)


def mlstm_chunk(S: int) -> int:
    """The chunk of a sequence of S tokens, min(MLSTM_CHUNK, S); S must be
    a multiple of it, as the reference asserts."""
    Cc = min(MLSTM_CHUNK, S)
    if S % Cc:
        raise ValueError(f"the mLSTM's chunkwise form needs a sequence length "
                         f"that is a multiple of its chunk {Cc}; got {S}")
    return Cc


def _mlstm_cells(q, k, v, i_pre, f_pre):
    """The chunkwise walk of q, k, v (B, S, nh, dh) and the gates from a
    zero state: (h (B, S, nh, dh) bf16, final C, final n)."""
    ig, lf = _gate_acts(i_pre, f_pre)
    B, S, nh, dh = q.shape
    Cc = mlstm_chunk(S)
    C = torch.zeros((B, nh, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, nh, dh), dtype=torch.float32, device=q.device)
    ys = []
    for s in range(0, S, Cc):
        c = slice(s, s + Cc)
        C, n, y = _mlstm_chunk_step(C, n, q[:, c], k[:, c], v[:, c], ig[:, c], lf[:, c])
        ys.append(y)
    return torch.cat(ys, 1), C, n


def _mlstm(p: MLSTM, x, cfg: ModelConfig):
    """The block over a whole sequence: (output, final C, final n). On a
    mesh the walk runs on each rank's batch rows."""
    mlstm_chunk(x.shape[1])
    q, k, v, ig, lf, z = _mlstm_qkvif(p, x, cfg)
    if sharding.on_mesh(q):
        row = _row(q)
        h, C, n = sharding.region(_mlstm_cells, (q, k, v, ig, lf), (row,) * 5,
                                  (row, row, row))
    else:
        h, C, n = _mlstm_cells(q, k, v, ig, lf)
    return _mlstm_out(p, h, z, cfg), C, n


def _row(t) -> list:
    """Placements of a tensor sharded on its batch dim alone, on `t`'s mesh
    as the rules place the batch."""
    return sharding.current_rules().placements(t.shape[:1], ("batch",))


def mlstm(p: MLSTM, x, positions, cfg: ModelConfig):
    """Chunkwise-parallel mLSTM forward. x: (B, S, d)."""
    return _mlstm(p, x, cfg)[0]


def mlstm_prefill(p: MLSTM, x, positions, cfg: ModelConfig, cache_len: int):
    """Forward + the final (C, n) matrix-memory state."""
    out, C, n = _mlstm(p, x, cfg)
    return out, {"C": sharding.constrain(C, "batch", "heads", None, None),
                 "n": sharding.constrain(n, "batch", "heads", None)}


def mlstm_decode(p: MLSTM, x, cache: dict, pos: int, cfg: ModelConfig):
    """O(1) recurrent decode. cache: {C: (B, nh, dh, dh), n: (B, nh, dh)},
    f32, updated in place and returned."""
    q, k, v, ig, lf, z = _mlstm_qkvif(p, x, cfg)
    args = (q, k, v, ig, lf, cache["C"], cache["n"])
    if sharding.on_mesh(q):
        row = _row(q)
        h, C, n = sharding.region(_mlstm_step, args, (row,) * 7, (row,) * 3)
    else:
        h, C, n = _mlstm_step(*args)
    cache["C"].copy_(sharding.constrain(C, "batch", "heads", None, None))
    cache["n"].copy_(sharding.constrain(n, "batch", "heads", None))
    return _mlstm_out(p, h, z, cfg), cache


def _mlstm_step(q, k, v, i_pre, f_pre, C, n):
    """The recurrent update of (C, n) by one token: (h (B, 1, nh, dh)
    bf16, C, n)."""
    ig, lf = _gate_acts(i_pre, f_pre)
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()  # (B, nh, dh)
    ig, f = ig[:, 0], torch.exp(lf[:, 0])  # (B, nh)
    C = f[..., None, None] * C + ig[..., None, None] * torch.einsum(
        "bhd,bhe->bhde", k, v)
    n = f[..., None] * n + ig[..., None] * k
    y = torch.einsum("bhd,bhde->bhe", q, C)
    denom = torch.clamp_min(torch.einsum("bhd,bhd->bh", q, n).abs(), 1.0)
    h = (y / denom[..., None])[:, None]  # (B, 1, nh, dh)
    return h.to(COMPUTE_DTYPE), C, n


def mlstm_cache_shape(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """{name: (shape, dtype)} of one layer's decode cache."""
    nh = cfg.n_heads
    dh = MLSTM_PF * cfg.d_model // nh
    return {"C": ((batch, nh, dh, dh), PARAM_DTYPE),
            "n": ((batch, nh, dh), PARAM_DTYPE)}


# ===================================================================== #
# sLSTM
# ===================================================================== #
def slstm_ffn_width(d: int) -> int:
    return int(2 * round(SLSTM_PF * d / 2))


class SLSTM(nn.Module):
    """The sLSTM block's parameters by the reference's names: per gate g
    in (z, i, f, o) w_g (d, d), r_g (nh, dh, dh) and b_g (d,), f32; the
    gated post-FFN's w_ffn1 (d, 2·f2) and w_ffn2 (f2, d), bf16."""

    def __init__(self, cfg: ModelConfig, device, generator=None,
                 param_dtype=COMPUTE_DTYPE):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        dh = d // nh
        f2 = slstm_ffn_width(d)
        f32 = PARAM_DTYPE
        shapes = {}
        for g in GATES:
            shapes[f"w_{g}"] = ((d, d), 0, f32)
            shapes[f"r_{g}"] = ((nh, dh, dh), 1, f32)
            shapes[f"b_{g}"] = ((d,), None, f32, 0.0)
        shapes["w_ffn1"] = ((d, 2 * f2), 0, COMPUTE_DTYPE)
        shapes["w_ffn2"] = ((f2, d), 0, COMPUTE_DTYPE)
        register_params(self, shapes, device, generator, param_dtype)


def _slstm_preact(p: SLSTM, x):
    """The four gates' input pre-activations W_g·x + b_g, (4, B, S, d) f32."""
    if sharding.on_mesh(p.w_z):
        return torch.stack([sharding.einsum("bsd,de->bse", x, getattr(p, f"w_{g}"),
                                            f32=True) + getattr(p, f"b_{g}")
                            for g in GATES])
    xf = x.float()
    return torch.stack([torch.matmul(xf, getattr(p, f"w_{g}")) + getattr(p, f"b_{g}")
                        for g in GATES])


def _slstm_mesh(p: SLSTM, pre, state, cfg: ModelConfig):
    """`_slstm_run` on a mesh: the recurrence on each rank's batch rows,
    the recurrent matrices whole (their gradient partial across the batch
    shards). `state` None starts from zeros. Returns (h, state)."""
    rules = sharding.current_rules()
    row = rules.placements(pre.shape[1:2], ("batch",))
    pre_pl = [Shard(1) if pl.is_shard(0) else Replicate() for pl in row]
    names = [f"r_{g}" for g in GATES]
    r_pl = [Replicate()] * len(row)
    r_grad = sharding.partial_where_batch(r_pl, row)
    st = tuple(state or ())

    def run(pl, *rest):
        rs, old = rest[:4], rest[4:]
        if not old:
            old = (torch.zeros(pl.shape[1], cfg.d_model, dtype=torch.float32,
                               device=pl.device),) * 4
        h, new = _slstm_run(SimpleNamespace(**dict(zip(names, rs))), pl, old, cfg)
        return (h, *new)

    out = sharding.region(
        run, (pre, *(getattr(p, n) for n in names), *st),
        (pre_pl, *(r_pl,) * 4, *(row,) * len(st)), (row,) * 5,
        (pre_pl, *(r_grad,) * 4, *(row,) * len(st)))
    return out[0], tuple(out[1:])


def _slstm_run(p: SLSTM, pre, state, cfg: ModelConfig):
    """The recurrence over pre (4, B, S, d) from state (c, n, h, m), each
    (B, d) f32. Returns (h (B, S, d) f32, the final state).

    Inside the loop the states are laid out (nh, B, dh) and the four
    recurrent matrices stand side by side, (nh, dh, 4·dh): a step's
    recurrent pre-activations are then one batched product, h_{t-1}·r_g
    per head and gate as in the reference, with no copy between steps."""
    nh, d = cfg.n_heads, cfg.d_model
    dh = d // nh
    _, B, S, _ = pre.shape
    pre = pre.view(4, B, S, nh, dh).permute(2, 3, 1, 0, 4).contiguous()  # (S, nh, B, 4, dh)
    r = torch.cat([getattr(p, f"r_{g}") for g in GATES], -1)
    c, n, h, m = (s.view(B, nh, dh).transpose(0, 1) for s in state)
    hs = []
    for t in range(S):
        g = pre[t] + torch.bmm(h, r).view(nh, B, 4, dh)
        z = torch.tanh(g[:, :, 0])
        i_pre = torch.clamp_max(g[:, :, 1], I_CLAMP)
        o = torch.sigmoid(g[:, :, 3])
        lf_m = F.logsigmoid(g[:, :, 2]) + m
        m = torch.maximum(lf_m, i_pre)
        i_g = torch.exp(i_pre - m)
        f_g = torch.exp(lf_m - m)
        c = f_g * c + i_g * z
        n = torch.clamp_min(f_g * n + i_g, 1e-6)
        h = o * c / n
        hs.append(h)
    out = torch.stack(hs, 2).permute(1, 2, 0, 3).reshape(B, S, d)
    return out, tuple(s.transpose(0, 1).reshape(B, d) for s in (c, n, h, m))


def _slstm_ffn(p: SLSTM, h):
    up = matmul(h, p.w_ffn1)
    f2 = up.shape[-1] // 2
    g, u = sharding.split(up, [f2, f2])
    return matmul(F.silu(g.float()).to(u.dtype) * u, p.w_ffn2)


def _slstm(p: SLSTM, x, cfg: ModelConfig):
    B, d = x.shape[0], cfg.d_model
    if sharding.on_mesh(p.w_z):
        h, state = _slstm_mesh(p, _slstm_preact(p, x), None, cfg)
    else:
        zero = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        h, state = _slstm_run(p, _slstm_preact(p, x), (zero,) * 4, cfg)
    return _slstm_ffn(p, h.to(COMPUTE_DTYPE)), state


def slstm(p: SLSTM, x, positions, cfg: ModelConfig):
    """Sequential sLSTM over time + the gated post-FFN. x: (B, S, d)."""
    return _slstm(p, x, cfg)[0]


def slstm_prefill(p: SLSTM, x, positions, cfg: ModelConfig, cache_len: int):
    """Forward + the final (c, n, h, m) state."""
    out, state = _slstm(p, x, cfg)
    return out, {k: sharding.constrain(t, "batch", "tp")
                 for k, t in zip(("c", "n", "h", "m"), state)}


def slstm_decode(p: SLSTM, x, cache: dict, pos: int, cfg: ModelConfig):
    """Decode step. cache: {c, n, h, m: (B, d)}, f32, updated in place and
    returned."""
    names = ("c", "n", "h", "m")
    run = _slstm_mesh if sharding.on_mesh(p.w_z) else _slstm_run
    h, state = run(p, _slstm_preact(p, x), [cache[k] for k in names], cfg)
    for k, s in zip(names, state):
        cache[k].copy_(sharding.constrain(s, "batch", "tp"))
    return _slstm_ffn(p, h.to(COMPUTE_DTYPE)), cache


def slstm_cache_shape(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """{name: (shape, dtype)} of one layer's decode cache."""
    return {k: ((batch, cfg.d_model), PARAM_DTYPE) for k in ("c", "n", "h", "m")}
