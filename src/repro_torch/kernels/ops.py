"""Public wrappers of the kernels: device dispatch + obs billing.

A wrapper launches the hand-written CUDA kernel when its tensors lie on
a CUDA device and runs the kernel's plain PyTorch version when they lie
on the CPU — the choice is made by the tensors' device alone, and a
CUDA launch that fails raises: nothing falls back. Each call is billed
to the obs registry (`_account`) from the CUDA kernel's own launch plan
(`topk_l2.block_plan` / `leaf_block_plan`: the grid it launches, the
bytes the function moves, the arithmetic it does), whichever version
runs.

`launch_counts()` reports how often each CUDA kernel was launched (the
plain versions never count): the evidence that a run went through the
kernels.
"""
from __future__ import annotations

import torch

from .. import obs
from . import quantize
from . import topk_l2 as _tk


def launch_counts() -> dict:
    return dict(_tk.LAUNCHES)


def reset_launch_counts() -> None:
    for name in _tk.LAUNCHES:
        _tk.LAUNCHES[name] = 0


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for {t.device}")


def _account(kernel: str, plan: dict) -> None:
    """Bill one call to the registry: calls, bytes, FLOPs and launched
    blocks per kernel — the inputs of a roofline report."""
    reg = obs.REGISTRY
    reg.counter("kernel.calls", kernel=kernel).inc()
    reg.counter("kernel.hbm_bytes", kernel=kernel).inc(plan["hbm_bytes"])
    reg.counter("kernel.flops", kernel=kernel).inc(plan["flops"])
    reg.counter("kernel.blocks", kernel=kernel).inc(plan["blocks"])


def _radius_rows(r, rows: int, device) -> torch.Tensor:
    """Scalar or per-row euclidean radius as a contiguous (rows,) f32."""
    rb = torch.as_tensor(r, dtype=torch.float32, device=device)
    return rb.expand(rows).contiguous()


def _empty(rows: int, k: int, device, slots: bool):
    out = (
        torch.full((rows, k), float("inf"), device=device),
        torch.full((rows, k), -1, dtype=torch.int32, device=device),
    )
    if slots:
        out += (torch.full((rows, k), _tk.I32_MAX, dtype=torch.int32, device=device),)
    return out


def _leaf_select(q, cands, cgids, rb, k: int, cscale, billed: str):
    """Shared body of the leaf wrappers: bill, then kernel or plain."""
    rows, c, d = cands.shape
    if obs.REGISTRY.enabled:
        itemsize = cands.element_size()
        _account(billed, _tk.leaf_block_plan(rows, c, d, k, itemsize=itemsize))
        obs.REGISTRY.counter(
            "quantized.stream_bytes", dtype=quantize.dtype_name(cands.dtype)
        ).inc(rows * c * d * itemsize)
    args = (
        q.to(torch.float32).contiguous(),
        cands.contiguous(),
        cgids.to(torch.int32).contiguous(),
        _tk.radius_sq_upper(rb),
        k,
    )
    scale = cscale.to(torch.float32).contiguous() if cscale is not None else None
    if _on_cuda(cands, billed):
        return _tk.leaf_topk_cuda(*args, cscale=scale)
    return _tk.leaf_topk_plain(*args, cscale=scale)


def leaf_topk_l2_raw(q, cands, cgids, r, k: int, cscale=None):
    """Selection pass over possibly-quantized per-row candidates: streams
    `cands` at its storage width (f32 / bf16 / int8 + per-candidate
    `cscale`), keeps the k smallest by the (squared distance, slot) key
    under the conservatively squared gate of the euclidean `r` (already
    widened by the caller for quantization error), and returns the
    unrefined ``(sq (R, k), gids (R, k), slots (R, k))`` triple."""
    rows = cands.shape[0]
    if rows == 0 or cands.shape[1] == 0:
        return _empty(rows, k, cands.device, slots=True)
    rb = _radius_rows(r, rows, cands.device)
    return _leaf_select(q, cands, cgids, rb, k, cscale, "leaf_topk_l2_raw")


def _refine(sq, g, rb):
    """Exact euclidean gate on the k survivors: sqrt, then `d <= r`."""
    dl = torch.sqrt(sq)
    ok = dl <= rb[:, None]
    inf = torch.full_like(dl, float("inf"))
    return torch.where(ok, dl, inf), torch.where(ok, g, -1)


def leaf_topk_l2(q, cands, cgids, r, k: int):
    """Batched-candidates constrained top-k over f32 candidates: the
    phase-2 evaluator of f32 segments and of the quantized fallback.
    Returns ``(distances (R, k), gids (R, k))`` ascending with
    (+inf, -1) fill."""
    rows = q.shape[0]
    if rows == 0 or cands.shape[1] == 0:
        return _empty(rows, k, cands.device, slots=False)
    rb = _radius_rows(r, rows, cands.device)
    cands = cands.to(torch.float32)
    sq, g, _ = _leaf_select(q, cands, cgids, rb, k, None, "leaf_topk_l2")
    return _refine(sq, g, rb)


def topk_l2(q, p, gids, r, k: int):
    """Shared-points constrained top-k (the delta-arena scan): (Q, k)
    ascending (dist, gid) without materializing the (Q, N) matrix on
    the card. Empty input gives the all-padding answer."""
    m, n = q.shape[0], p.shape[0]
    if m == 0 or n == 0:
        return _empty(m, k, p.device, slots=False)
    rb = _radius_rows(r, m, p.device)
    if obs.REGISTRY.enabled:
        _account("topk_l2", _tk.block_plan(m, n, q.shape[1], k))
    args = (
        q.to(torch.float32).contiguous(),
        p.to(torch.float32).contiguous(),
        gids.to(torch.int32).contiguous(),
        _tk.radius_sq_upper(rb),
        k,
    )
    if _on_cuda(p, "topk_l2"):
        sq, g, _ = _tk.topk_cuda(*args)
    else:
        sq, g, _ = _tk.topk_plain(*args)
    return _refine(sq, g, rb)
