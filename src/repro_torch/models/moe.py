"""Mixture-of-Experts FFN with grouped capacity dispatch (a port of the
reference's `models/moe.py`).

Tokens are cut into G groups (`n_groups`); inside a group each expert
takes at most C assignments (`capacity`), in the flat token-major, then
top-k order, and the rest are dropped. The reference chose the grouping
to line up with its batch sharding, but it decides which tokens drop, so
the port copies it exactly. On a mesh the reference's constraints hold
(`_moe_mesh`): groups on data, experts on model.

The steps and their types follow the reference's:

  * router logits in f32 (bf16 activations times the f32 router), then
    softmax; the top k of each token's probabilities with the lower
    expert first on ties (`lax.top_k`'s order: a stable descending sort),
    renormalised by max(sum, 1e-9);
  * each assignment's slot is the running count of its expert inside its
    group; slots >= C are dropped;
  * a zeroed bf16 buffer (E, G, C, d) takes each kept token, the expert
    products run batched over E on (E, G·C, d) rows through
    `layers.matmul` (bf16 in, f32 sums, bf16 out), silu in f32;
  * each token gathers its k outputs, weighted by (top_w · keep) in bf16,
    summed over k in f32 and rounded once (as `jnp.sum` does for bf16),
    plus the shared experts' MLP;
  * the load-balance loss Σ(mean prob · assignment share)·E·weight in f32.

Every kept (expert, group, slot) receives exactly one token, so the
reference's scatter-add into zeros is a plain write here. The reference
computes the expert products as einsums outside any Pallas kernel, so
they are library products here too.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Partial, Replicate

from . import sharding
from .config import ModelConfig
from .layers import (COMPUTE_DTYPE, PARAM_DTYPE, fanin, init_mlp, matmul,
                     mlp, stored)


class MoE(nn.Module):
    """The MoE FFN's parameters by the reference's names: the router
    (d, E) f32, the routed experts' w_gate and w_up (E, d, d_expert) and
    w_down (E, d_expert, d) bf16, and the shared experts' gated MLP of
    width n_shared · d_expert. With a `generator` they are drawn as the
    reference's `init_moe` draws them; without one they are left empty.

    Called as `moe(x, cfg)`, through the module, so that a forward hook
    can observe the routing's input (`routing_trace`)."""

    def __init__(self, cfg: ModelConfig, device, generator=None,
                 param_dtype=COMPUTE_DTYPE):
        super().__init__()
        d, fe, e = cfg.d_model, cfg.d_expert, cfg.n_experts
        shapes = {
            "router": ((d, e), 0, PARAM_DTYPE),
            "w_gate": ((e, d, fe), 1, COMPUTE_DTYPE),
            "w_up": ((e, d, fe), 1, COMPUTE_DTYPE),
            "w_down": ((e, fe, d), 1, COMPUTE_DTYPE),
        }
        for name, (shape, fan_axis, dtype) in shapes.items():
            dtype = stored(dtype, param_dtype)
            if generator is None:
                t = torch.empty(shape, dtype=dtype, device=device)
            else:
                t = fanin(shape, generator, device, fan_axis=fan_axis, dtype=dtype)
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        if cfg.n_shared:
            f = cfg.n_shared * fe
            if generator is not None:
                ws = init_mlp(d, f, True, generator, device, param_dtype)
            else:
                ws = {n: torch.empty((f, d) if n == "w_down" else (d, f),
                                     dtype=param_dtype, device=device)
                      for n in ("w_gate", "w_up", "w_down")}
            self.shared = nn.ParameterDict(
                {n: nn.Parameter(t, requires_grad=False) for n, t in ws.items()})

    def forward(self, x: torch.Tensor, cfg: ModelConfig):
        return moe(self, x, cfg)


def n_groups(cfg: ModelConfig, tokens: int) -> int:
    """Dispatch groups: the largest of 32, 16, ... that divides the token
    count (the reference's widest batch sharding, pod x data = 32)."""
    g = 32
    while tokens % g:
        g //= 2
    return max(g, 1)


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def route(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """The routing of x (B, S, d): (probs (G, Tg, E) f32, top_w (G, Tg, k)
    f32 renormalised, flat_e (G, Tg·k) expert ids, slot (G, Tg·k) — C
    where the assignment is dropped — and C)."""
    B, S, d = x.shape
    G = n_groups(cfg, B * S)
    Tg = B * S // G
    C = capacity(cfg, Tg)
    return (*_route_groups(x.reshape(G, Tg, d), p.router, cfg, C), C)


def _route_groups(xg: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
                  C: int):
    """`route` of the groups xg (G, Tg, d): (probs, top_w, flat_e, slot)."""
    G, Tg, _ = xg.shape
    k = cfg.top_k
    logits = torch.matmul(xg.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :k], top_i[..., :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_i.reshape(G, Tg * k)
    oh = F.one_hot(flat_e, cfg.n_experts)                  # (G, Tg·k, E)
    pos = torch.gather(torch.cumsum(oh, dim=1) - 1, 2, flat_e[..., None])[..., 0]
    slot = torch.where(pos < C, pos, C)
    return probs, top_w, flat_e, slot


@contextlib.contextmanager
def routing_trace(model: nn.Module):
    """Within the block, every call of one of `model`'s MoE FFNs appends
    (its module name, its input x (B, S, d), the experts chosen flat_e
    (G, Tg·k), which of those assignments were dropped for capacity (a
    bool mask of the same shape)) to the list yielded. A forward hook
    recomputes `route` on the call's input; the entries are tensors on the
    model's device (nothing is synchronised)."""
    calls, handles = [], []

    def hook(name):
        def record(module, args, _out):
            _, _, flat_e, slot, C = route(module, *args)
            calls.append((name, args[0], flat_e, slot == C))
        return record

    for name, module in model.named_modules():
        if isinstance(module, MoE):
            handles.append(module.register_forward_hook(hook(name)))
    try:
        yield calls
    finally:
        for h in handles:
            h.remove()


def moe(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) bf16 -> (out (B, S, d) bf16, aux loss () f32)."""
    if isinstance(p.w_up, DTensor):
        return _moe_mesh(p, x, cfg)
    B, S, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    T = B * S
    probs, top_w, flat_e, slot, C = route(p, x, cfg)
    G = flat_e.shape[0]
    Tg = T // G
    keep = slot < C
    # dispatch: one write per kept assignment; dropped ones land in the
    # spare slot C, which is cut off
    g_idx = torch.arange(G, device=x.device)[:, None].expand(G, Tg * k)
    x_rep = x.reshape(G, Tg, 1, d).expand(G, Tg, k, d).reshape(G, Tg * k, d)
    buf = torch.zeros((e, G, C + 1, d), dtype=COMPUTE_DTYPE, device=x.device)
    buf[flat_e, g_idx, slot] = x_rep.to(COMPUTE_DTYPE)
    rows = buf[:, :, :C].reshape(e, G * C, d)
    g_ = matmul(rows, p.w_gate)
    u = matmul(rows, p.w_up)
    h = F.silu(g_.float()).to(u.dtype) * u
    out_buf = matmul(h, p.w_down).view(e, G, C, d)
    # combine: each assignment's output (a dropped one reads slot C - 1
    # and is weighted 0), weighted in bf16, summed over k in f32
    gathered = out_buf[flat_e, g_idx, torch.clamp(slot, max=C - 1)]
    w = (top_w.reshape(G, Tg * k) * keep).to(COMPUTE_DTYPE)
    y = (gathered * w[..., None]).view(G, Tg, k, d).float().sum(2)
    y = y.to(COMPUTE_DTYPE).reshape(B, S, d)
    if cfg.n_shared:
        y = y + mlp(p.shared, x)
    # load-balance auxiliary loss (Switch/GShard form)
    me = probs.reshape(T, e).mean(dim=0)
    ce = torch.bincount(flat_e.reshape(-1), minlength=e).float() / (T * k)
    aux = (me * ce).sum() * e * cfg.router_aux_weight
    return y, aux


def _dispatch_local(xg, router, cfg: ModelConfig, C: int):
    """One rank's groups xg (Gl, Tg, d): the routing, the dispatch buffer
    (Gl, E, C, d) bf16, the combine's inputs, and the load-balance sums
    of its tokens (probabilities by expert, assignments by expert)."""
    Gl, Tg, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    probs, top_w, flat_e, slot = _route_groups(xg, router, cfg, C)
    g_idx = torch.arange(Gl, device=xg.device)[:, None].expand(Gl, Tg * k)
    x_rep = xg.reshape(Gl, Tg, 1, d).expand(Gl, Tg, k, d).reshape(Gl, Tg * k, d)
    buf = torch.zeros((e, Gl, C + 1, d), dtype=COMPUTE_DTYPE, device=xg.device)
    buf[flat_e, g_idx, slot] = x_rep.to(COMPUTE_DTYPE)
    counts = torch.bincount(flat_e.reshape(-1), minlength=e).float()
    return (buf[:, :, :C].permute(1, 0, 2, 3), top_w, flat_e, slot,
            probs.reshape(-1, e).sum(0), counts)


def _combine_local(out_buf, top_w, flat_e, slot, cfg: ModelConfig):
    """One rank's groups: each assignment's expert output weighted in
    bf16, summed over k in f32 and rounded once. out_buf (Gl, E, C, d)."""
    Gl, _, C, d = out_buf.shape
    k = cfg.top_k
    Tgk = flat_e.shape[1]
    g_idx = torch.arange(Gl, device=out_buf.device)[:, None].expand(Gl, Tgk)
    gathered = out_buf[g_idx, flat_e, torch.clamp(slot, max=C - 1)]
    w = (top_w.reshape(Gl, Tgk) * (slot < C)).to(COMPUTE_DTYPE)
    y = (gathered * w[..., None]).view(Gl, Tgk // k, k, d).float().sum(2)
    return y.to(COMPUTE_DTYPE)


def _moe_mesh(p: MoE, x, cfg: ModelConfig):
    """The MoE on a mesh with the reference's constraints: tokens by batch,
    then groups by `fsdp` (data); the dispatch buffer by (fsdp, exp) and
    the expert rows by (exp, fsdp), so each rank runs its experts on its
    groups' rows; routing and combine run on each rank's groups (the
    router is replicated, its gradient partial across the groups'
    shards); the load-balance loss sums its two means across them."""
    B, S, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    T = B * S
    G = n_groups(cfg, T)
    Tg = T // G
    C = capacity(cfg, Tg)
    x = sharding.constrain(x, "batch", None, None)
    xg = sharding.constrain(x.reshape(G, Tg, d), "fsdp", None, None)
    g_pl = sharding.row_placements_of(list(xg.placements))
    mesh = xg.device_mesh
    r_pl = [pl for pl in p.router.placements]
    part = [Partial() if (pl.is_shard() and pl.dim == 0) else pl for pl in g_pl]
    buf, top_w, flat_e, slot, psum, counts = sharding.region(
        lambda xl, rl: _dispatch_local(xl, rl, cfg, C), (xg, p.router),
        (g_pl, r_pl), (g_pl, g_pl, g_pl, g_pl, part, part),
        (g_pl, sharding.partial_where_batch(r_pl, g_pl)))
    buf = sharding.constrain(buf, "fsdp", "exp", None, None)
    rows = sharding.constrain(buf.transpose(0, 1).reshape(e, G * C, d),
                              "exp", "fsdp", None)
    g_ = matmul(rows, p.w_gate)
    u = matmul(rows, p.w_up)
    h = F.silu(g_.float()).to(u.dtype) * u
    out_rows = sharding.constrain(matmul(h, p.w_down), "exp", "fsdp", None)
    out_buf = sharding.constrain(out_rows.reshape(e, G, C, d).transpose(0, 1),
                                 "fsdp", "exp", None, None)
    y = sharding.region(
        lambda ob, tw, fe, sl: _combine_local(ob, tw, fe, sl, cfg),
        (out_buf, top_w, flat_e, slot), (g_pl, g_pl, g_pl, g_pl), g_pl)
    y = y.reshape(B, S, d)
    if cfg.n_shared:
        y = y + mlp(p.shared, x)
    whole = [Replicate()] * mesh.ndim
    me = psum.redistribute(mesh, whole) / T
    ce = counts.redistribute(mesh, whole) / (T * k)
    aux = (me * ce).sum() * e * cfg.router_aux_weight
    return sharding.constrain(y, "batch", None, None), aux
