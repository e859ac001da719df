"""Public wrappers of the kernels: device dispatch + obs billing.

A wrapper launches the hand-written CUDA kernel when its tensors lie on
a CUDA device and runs the kernel's plain PyTorch version when they lie
on the CPU — the choice is made by the tensors' device alone, and a
CUDA launch that fails raises: nothing falls back. Each call is billed
to the obs registry (`_account`) from the CUDA kernel's own launch plan
(`topk_l2.block_plan` / `leaf_block_plan`, `pairwise_l2.block_plan`,
`cov_matvec.block_plan`: the grid it launches, the bytes the function
moves, the arithmetic it does), whichever version runs. Each call also
resolves its launch geometry through the autotuner (`autotune.
choose_plan`, one cached decision per kernel, shape class, k, dtype and
backend, which `decisions()` lists): `topk_l2` launches the chosen
split; the other kernels have one plan each, recorded all the same.
`leaf_topk_l2_raw` alone bills the quantized stream
(`quantized.stream_bytes{dtype}`, at the candidates' storage width with
the int8 scale, and `quantized.f32_stream_bytes{dtype}`, the same stream
at 4 bytes an element), as the reference does.

Two families, as in the reference's `kernels/ops.py`:

  * the constrained top-k scans of the read path (`leaf_topk_l2_raw`,
    `leaf_topk_l2`, `topk_l2`);
  * the kernel primitives (`pairwise_sq_l2`, `pairwise_l2`,
    `lower_bounds` — the paper's pruning bound D_N of §4.2 batched over
    queries × nodes —, `cov_matvec` and `power_iteration`, the PCA
    direction of §3.2).

`launch_counts()` reports how often each CUDA kernel was launched on the
device (`topk_l2` and the pairwise kernel's wide route launch two per
call, the others one; the plain versions never count): the evidence that a run went through the kernels.
`topk_l2.LAUNCH_SHAPES` splits both top-k kernels' launches by the
call's shape (`topk_l2.launches_by_q()` topk_l2's by its query count);
`reset_launch_counts()` clears it too.
"""
from __future__ import annotations

import torch

from .. import obs
from . import autotune as _at
from . import cov_matvec as _cm
from . import pairwise_l2 as _pw
from . import quantize
from . import topk_l2 as _tk

_COUNTERS = (_tk.LAUNCHES, _pw.LAUNCHES, _cm.LAUNCHES)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def launch_counts() -> dict:
    out = {}
    for counts in _COUNTERS:
        out.update(counts)
    return out


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0
    _tk.LAUNCH_SHAPES.clear()


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
    """Shared body of the leaf wrappers: plan, bill, then kernel or plain."""
    rows, c, d = cands.shape
    sdt = quantize.dtype_name(cands.dtype)
    _at.choose_plan("leaf_topk_l2", rows, c, d, k, dtype=sdt,
                    backend=cands.device.type)
    if obs.REGISTRY.enabled:
        itemsize = cands.element_size()
        plan = _tk.leaf_block_plan(rows, c, d, k, itemsize=itemsize)
        _account(billed, plan)
        if billed == "leaf_topk_l2_raw":
            # what this call streamed at storage width, and what the same
            # call would have streamed in f32
            reg = obs.REGISTRY
            reg.counter("quantized.stream_bytes", dtype=sdt).inc(plan["stream_bytes"])
            reg.counter("quantized.f32_stream_bytes", dtype=sdt).inc(
                _tk.leaf_block_plan(rows, c, d, k)["stream_bytes"])
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
    d = q.shape[1]
    plan = _at.choose_plan("topk_l2", m, n, d, k, backend=p.device.type)
    if obs.REGISTRY.enabled:
        _account("topk_l2", _tk.block_plan(m, n, d, k))
    args = (
        q.to(torch.float32).contiguous(),
        p.to(torch.float32).contiguous(),
        gids.to(torch.int32).contiguous(),
        _tk.radius_sq_upper(rb),
        k,
    )
    if _on_cuda(p, "topk_l2"):
        sq, g, _ = _tk.topk_cuda(*args, split=plan["split"])
    else:
        sq, g, _ = _tk.topk_plain(*args)
    return _refine(sq, g, rb)


# -- kernel primitives ---------------------------------------------------------
def _kernel_dtype(*ts):
    """The inputs as the kernels take them: f32 or bf16 kept when they
    all share it, anything else (f64, f16, mixed) widened to f32."""
    if ts[0].dtype in _KERNEL_DTYPES and all(t.dtype == ts[0].dtype for t in ts):
        return ts
    return tuple(t.to(torch.float32) for t in ts)


def pairwise_sq_l2(q, p):
    """Squared L2 distance matrix (M, N) f32 of q (M, D) and p (N, D), in
    the expansion form |q|² + |p|² − 2·q·p clamped at 0."""
    q, p = _kernel_dtype(q, p)
    m, d = q.shape
    n = p.shape[0]
    _at.choose_plan("pairwise_sq_l2", m, n, d, dtype=quantize.dtype_name(q.dtype),
                    backend=p.device.type)
    if obs.REGISTRY.enabled:
        _account("pairwise_sq_l2", _pw.block_plan(m, n, d, q.element_size()))
    if _on_cuda(p, "pairwise_sq_l2"):
        return _pw.pairwise_cuda(q.contiguous(), p.contiguous())
    return _pw.pairwise_plain(q, p)


def pairwise_l2(q, p):
    """Euclidean distance matrix (M, N) f32."""
    return torch.sqrt(pairwise_sq_l2(q, p))


def lower_bounds(q, centers, radii):
    """Ball lower bounds max(0, ||q-c|| - radius): the pruning quantity
    D_N of the paper's search (§4.2), batched over queries × nodes."""
    d = pairwise_l2(q, centers)
    return torch.clamp(d - radii.to(torch.float32)[None, :], min=0.0)


def cov_matvec(x, mean, w):
    """Fused centered-covariance matvec (one power-iteration step):
    y = (X-μ)ᵀ((X-μ)w), (D,) f32, with x read once at its width."""
    (x,) = _kernel_dtype(x)
    n, d = x.shape
    _at.choose_plan("cov_matvec", n, d, d, dtype=quantize.dtype_name(x.dtype),
                    backend=x.device.type)
    if obs.REGISTRY.enabled:
        _account("cov_matvec", _cm.block_plan(n, d, x.element_size()))
    mean = mean.to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    if _on_cuda(x, "cov_matvec"):
        return _cm.cov_matvec_cuda(x.contiguous(), mean, w)
    return _cm.cov_matvec_plain(x, mean, w)


def power_iteration(x, iters: int = 16, generator=None):
    """First principal component of x (N, D) using the fused kernel.

    The start vector is a standard normal draw from `generator` (a
    `torch.Generator` on x's device; default: a fresh one seeded 0),
    normalised. Each step keeps the reference's update
    `where(|v| > 1e-12, v / max(|v|, 1e-30), w)` on the device, so the
    loop never waits for the host, and a degenerate x (every row equal)
    returns the start vector."""
    (x,) = _kernel_dtype(x)
    d = x.shape[1]
    mean = x.mean(dim=0)
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    w = torch.randn(d, generator=generator, device=x.device, dtype=torch.float32)
    w = w / torch.linalg.vector_norm(w)
    for _ in range(iters):
        v = cov_matvec(x, mean, w)
        nrm = torch.linalg.vector_norm(v)
        w = torch.where(nrm > 1e-12, v / torch.clamp(nrm, min=1e-30), w)
    return w
