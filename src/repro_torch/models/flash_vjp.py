"""Flash-style chunked causal attention and its backward: a port of the
reference's `models/flash_vjp.py`.

The reference wraps `_forward` in a `jax.custom_vjp`; the port wraps it
in a `torch.autograd.Function` (`FlashCausal`) that saves only (q, k, v,
out, row max m, row sum l). Its backward (`_backward`, the reference's
`_bwd`) walks the same pair schedule and recomputes each score block,
so the residual memory is O(S) a head, not O(S²/C) per pair.

`_scan` is the online-softmax walk over the static (q-chunk, kv-chunk)
pair schedule that both branches of `attention.chunked_causal` run. The
two branches differ only in the type of their products' operands and in
where the output is rounded: the flash branch multiplies in q's and v's
own types and keeps the output in f32 until the end; the other branch
rounds its operands to bf16 and rounds each row block's output to bf16.
A row's output is final after the last pair of its row, so writing it
there alone gives the same numbers as the reference, which writes the
row after every pair.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def _pair_schedule(R: int, C: int, window: int, packing: bool):
    """Static (q-chunk, kv-chunk) visit schedule, row-major; with
    `packing` only the lower triangle (and, under a window, only the
    chunks that overlap it)."""
    pairs = []
    for i in range(R):
        if packing:
            j_min = 0
            if window:
                j_min = max(0, (i * C - (window - 1)) // C)
            js = range(j_min, i + 1)
        else:
            js = range(R)
        for j in js:
            pairs.append((i, j))
    qi = np.asarray([p[0] for p in pairs], np.int32)
    kj = np.asarray([p[1] for p in pairs], np.int32)
    start = np.zeros(len(pairs), bool)
    start[0] = True
    start[1:] = qi[1:] != qi[:-1]
    return qi, kj, start


def _wide(q: torch.Tensor) -> torch.dtype:
    """The type of the walk's sums: f32, or f64 for f64 inputs."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _mask(i: int, j: int, C: int, window: int, device) -> torch.Tensor:
    qpos = i * C + torch.arange(C, device=device)
    kpos = j * C + torch.arange(C, device=device)
    m = kpos[None, :] <= qpos[:, None]
    if window:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _scan(q, k, v, C: int, window: int, packing: bool, scale: float,
          to_bf16: bool):
    """Online softmax over the pair schedule. q: (B, S, KV, G, hd), k:
    (B, S, KV, hd), v: (B, S, KV, hdv), S a multiple of C. With `to_bf16`
    every product operand (q, k, the probabilities, v) is rounded to
    bf16 first; without, q, k and v keep their own types and the
    probabilities take v's. Both products sum in f32. Returns the
    normalised output (B, S, KV, G, hdv) f32 and the row max and row sum
    (B, S, KV, G) f32 (f64 throughout where q is f64: the tests' exact
    referent for the backward)."""
    B, S, KV, G, hd = q.shape
    hdv = v.shape[-1]
    R = S // C
    dev = q.device
    wide = _wide(q)
    out = torch.zeros((B, S, KV, G, hdv), dtype=wide, device=dev)
    mrow = torch.full((B, S, KV, G), NEG_INF, dtype=wide, device=dev)
    lrow = torch.zeros((B, S, KV, G), dtype=wide, device=dev)
    # the operands in f32 holding their rounded values: exact products
    pv_dtype = torch.bfloat16 if to_bf16 else v.dtype
    qf, kf, vf = (t.to(torch.bfloat16 if to_bf16 else t.dtype).to(wide)
                  for t in (q, k, v))
    qi, kj, start = _pair_schedule(R, C, window, packing)
    last = np.append(start[1:], True)  # the row's last pair
    for i, j, st, end in zip(qi.tolist(), kj.tolist(), start, last):
        if st:
            m = torch.full((B, KV, G, C), NEG_INF, dtype=wide, device=dev)
            l = torch.zeros((B, KV, G, C), dtype=wide, device=dev)
            acc = torch.zeros((B, KV, G, C, hdv), dtype=wide, device=dev)
        qt = qf[:, i * C:(i + 1) * C].permute(0, 2, 3, 1, 4)  # (B, KV, G, C, hd)
        kt = kf[:, j * C:(j + 1) * C].permute(0, 2, 3, 1)     # (B, KV, hd, C)
        vt = vf[:, j * C:(j + 1) * C].permute(0, 2, 1, 3)     # (B, KV, C, hdv)
        s = torch.matmul(qt.reshape(B, KV, G * C, hd), kt)
        s = s.view(B, KV, G, C, C) * scale
        s = torch.where(_mask(i, j, C, window, dev), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # fully-masked-so-far rows: keep alpha/p at 0, not nan
        alpha = torch.where(m <= NEG_INF, 0.0, torch.exp(m - m_new))
        p = torch.where(m_new[..., None] <= NEG_INF, 0.0,
                        torch.exp(s - m_new[..., None]))
        l = l * alpha + p.sum(-1)
        pv = torch.matmul(p.to(pv_dtype).to(wide).reshape(B, KV, G * C, C), vt)
        acc = acc * alpha[..., None] + pv.view(B, KV, G, C, hdv)
        m = m_new
        if end:
            rows = slice(i * C, (i + 1) * C)
            norm = acc / torch.clamp(l[..., None], min=1e-30)
            out[:, rows] = norm.permute(0, 3, 1, 2, 4)
            mrow[:, rows] = m.permute(0, 3, 1, 2)
            lrow[:, rows] = l.permute(0, 3, 1, 2)
    return out, mrow, lrow


def _forward(q, k, v, chunk: int, window: int, packing: bool, scale: float):
    """The reference's `_forward`: products in q's and v's types, the
    output kept in f32 and cast to q's type once. Returns (out, row max,
    row sum)."""
    out, mrow, lrow = _scan(q, k, v, chunk, window, packing, scale, False)
    return out.to(q.dtype), mrow, lrow


def _backward(q, k, v, out, mrow, lrow, dout, C: int, window: int,
              packing: bool, scale: float):
    """The reference's `_bwd`: for each (q-chunk i, kv-chunk j) pair,
    recompute p = exp(s - m) / l from the saved row max and sum, then
    dv_j += pᵀ·dout_i, ds = p·(dout_i·v_jᵀ − D_i)·scale, dq_i += ds·k_j,
    dk_j += dsᵀ·q_i, with D = rowsum(dout·out). Every product takes the
    reference's operand types (q's for the scores and dk, v's for p, dout
    in dv and dp, k's for ds in dq), held in f32 so that each product is
    exact and the sum f32; dq, dk and dv are summed in f32 and cast once
    to q's, k's and v's types."""
    B, S, KV, G, hd = q.shape
    R = S // C
    dev = q.device
    wide = _wide(q)

    def rounded(t, dtype):
        return t.to(dtype).to(wide)

    D = (dout.to(wide) * out.to(wide)).sum(-1)        # (B, S, KV, G)
    qf, kf, vf = q.to(wide), k.to(wide), v.to(wide)
    do_v = rounded(dout, v.dtype)                  # dout in v's type
    dq = torch.zeros(q.shape, dtype=wide, device=dev)
    dk = torch.zeros(k.shape, dtype=wide, device=dev)
    dv = torch.zeros(v.shape, dtype=wide, device=dev)
    qi, kj, _ = _pair_schedule(R, C, window, packing)
    for i, j in zip(qi.tolist(), kj.tolist()):
        rows, cols = slice(i * C, (i + 1) * C), slice(j * C, (j + 1) * C)
        qt = qf[:, rows].permute(0, 2, 3, 1, 4)    # (B, KV, G, C, hd)
        dot = do_v[:, rows].permute(0, 2, 3, 1, 4)  # (B, KV, G, C, hdv)
        kt = kf[:, cols].permute(0, 2, 1, 3)       # (B, KV, C, hd)
        vt = vf[:, cols].permute(0, 2, 1, 3)       # (B, KV, C, hdv)
        mt = mrow[:, rows].permute(0, 2, 3, 1)[..., None]  # (B, KV, G, C, 1)
        lt = torch.clamp(lrow[:, rows].permute(0, 2, 3, 1), min=1e-30)[..., None]
        Dt = D[:, rows].permute(0, 2, 3, 1)[..., None]
        s = torch.matmul(qt, kt.transpose(-1, -2)[:, :, None]) * scale
        s = torch.where(_mask(i, j, C, window, dev), s, NEG_INF)
        p = torch.where(mt <= NEG_INF, 0.0, torch.exp(s - mt)) / lt
        pv = rounded(p, v.dtype)
        dvc = torch.einsum("bkgqt,bkgqh->bkth", pv, dot)
        dp = torch.matmul(dot, vt.transpose(-1, -2)[:, :, None])
        ds = p * (dp - Dt) * scale
        dqc = torch.matmul(rounded(ds, k.dtype), kt[:, :, None])
        dkc = torch.einsum("bkgqt,bkgqh->bkth", rounded(ds, q.dtype), qt)
        dq[:, rows] += dqc.permute(0, 3, 1, 2, 4)
        dk[:, cols] += dkc.permute(0, 2, 1, 3)
        dv[:, cols] += dvc.permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashCausal(torch.autograd.Function):
    """`_forward`'s output with the reference's flash backward: saves (q,
    k, v, out, row max, row sum) and nothing of the pair walk."""

    @staticmethod
    def forward(ctx, q, k, v, chunk: int, window: int, packing: bool,
                scale: float):
        out, mrow, lrow = _forward(q, k, v, chunk, window, packing, scale)
        ctx.save_for_backward(q, k, v, out, mrow, lrow)
        ctx.walk = (chunk, window, packing, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, mrow, lrow = ctx.saved_tensors
        grads = _backward(q, k, v, out, mrow, lrow, dout, *ctx.walk)
        return (*grads, None, None, None, None)


def flash_causal(q, k, v, chunk: int, window: int, packing: bool,
                 scale: float) -> torch.Tensor:
    """Chunked causal attention with the flash backward (`FlashCausal`);
    where autograd does not record, its forward alone runs."""
    return FlashCausal.apply(q, k, v, chunk, window, packing, scale)
