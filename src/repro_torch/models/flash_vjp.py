"""Flash-style chunked causal attention: the forward of the reference's
`models/flash_vjp.py`.

The reference wraps `_forward` in a `jax.custom_vjp` whose backward
recomputes each score block from (out, row max m, row sum l). Serving
needs only the forward, which is what this module ports; the backward,
as a `torch.autograd.Function`, comes with the port of training.

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
    (B, S, KV, G) f32."""
    B, S, KV, G, hd = q.shape
    hdv = v.shape[-1]
    R = S // C
    dev = q.device
    f32 = torch.float32
    out = torch.zeros((B, S, KV, G, hdv), dtype=f32, device=dev)
    mrow = torch.full((B, S, KV, G), NEG_INF, dtype=f32, device=dev)
    lrow = torch.zeros((B, S, KV, G), dtype=f32, device=dev)
    # the operands in f32 holding their rounded values: exact products
    pv_dtype = torch.bfloat16 if to_bf16 else v.dtype
    qf, kf, vf = (t.to(torch.bfloat16 if to_bf16 else t.dtype).to(f32)
                  for t in (q, k, v))
    qi, kj, start = _pair_schedule(R, C, window, packing)
    last = np.append(start[1:], True)  # the row's last pair
    for i, j, st, end in zip(qi.tolist(), kj.tolist(), start, last):
        if st:
            m = torch.full((B, KV, G, C), NEG_INF, dtype=f32, device=dev)
            l = torch.zeros((B, KV, G, C), dtype=f32, device=dev)
            acc = torch.zeros((B, KV, G, C, hdv), dtype=f32, device=dev)
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
        pv = torch.matmul(p.to(pv_dtype).to(f32).reshape(B, KV, G * C, C), vt)
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


def flash_causal(q, k, v, chunk: int, window: int, packing: bool,
                 scale: float) -> torch.Tensor:
    out, _, _ = _forward(q, k, v, chunk, window, packing, scale)
    return out
