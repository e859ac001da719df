"""The hand-written CUDA kernels == their plain PyTorch versions, bitwise.

Marked `cuda`: skipped where there is no card. On a machine with one
(which has no JAX, and this repo's tests/conftest.py imports it):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The plain versions repeat each kernel's arithmetic operation by
operation (explicitly rounded, uncontracted f32, in the kernel's order
of sums), so every output must be equal — sq, gid and slot of the top-k
kernels, the pairwise matrix on its narrow route, the covariance matvec
— no tolerance. The one exception is the pairwise kernel's wide route
(D >= pairwise_l2.WIDE_MIN_D), whose cross term runs on the tensor
cores: it is held to the expansion form's ceiling instead.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cov_matvec as cm
from repro_torch.kernels import ops, quantize
from repro_torch.kernels import pairwise_l2 as pw
from repro_torch.kernels import topk_l2 as tk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _leaf_case(sdt, rows=67, c=300, d=3, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((rows, d)).astype(np.float32)
    cands = (q[:, None, :] + 0.7 * rng.standard_normal((rows, c, d)))
    cands = torch.from_numpy(cands.astype(np.float32))
    cg = rng.permutation(rows * c).reshape(rows, c).astype(np.int32)
    cg[rng.random((rows, c)) < 0.2] = -1
    r = torch.from_numpy(rng.uniform(0.4, 1.6, rows).astype(np.float32))
    # each row one "leaf": one scale per row, broadcast per candidate
    store, scale, _ = quantize.quantize_leaves(cands, sdt)
    cscale = None
    if scale is not None:
        cscale = scale[:, None].expand(rows, c).contiguous()
    store = cands if store is None else store
    return (torch.from_numpy(q), store, torch.from_numpy(cg),
            tk.radius_sq_upper(r)), cscale


@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [1, 21, 40])
def test_leaf_kernel_equals_plain(dev, sdt, k):
    args, cscale = _leaf_case(sdt)
    want = tk.leaf_topk_plain(*args, k, cscale=cscale)
    got = tk.leaf_topk_cuda(
        *[a.to(dev) for a in args], k,
        cscale=None if cscale is None else cscale.to(dev),
    )
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("n,d,k", [(2100, 5, 11), (3, 2, 7), (5000, 2, 10)])
def test_topk_kernel_equals_plain(dev, n, d, k):
    rng = np.random.default_rng(n)
    q = torch.from_numpy(rng.standard_normal((37, d)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    g = np.where(rng.random(n) < 0.2, -1, np.arange(n)).astype(np.int32)
    g = torch.from_numpy(g)
    r_sq = tk.radius_sq_upper(torch.full((37,), 1.5))
    want = tk.topk_plain(q, p, g, r_sq, k)
    got = tk.topk_cuda(q.to(dev), p.to(dev), g.to(dev), r_sq.to(dev), k)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


def _leaf_equal(dev, args, cscale, k):
    want = tk.leaf_topk_plain(*args, k, cscale=cscale)
    got = tk.leaf_topk_cuda(
        *[a.to(dev) for a in args], k,
        cscale=None if cscale is None else cscale.to(dev),
    )
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)
    return want


@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [32, 33])
def test_leaf_kernel_list_boundary(dev, sdt, k):
    """k' = 32 takes the register list, 33 the shared-memory list; the
    vector path (D = 2) and the element path (D = 3) under both."""
    for d in (2, 3):
        args, cscale = _leaf_case(sdt, rows=40, c=500, d=d, seed=k)
        _leaf_equal(dev, args, cscale, k)


@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "int8"])
def test_leaf_kernel_main_path_shape(dev, sdt):
    """C = 2,048 at D = 2, the main path's shape: the vector path."""
    args, cscale = _leaf_case(sdt, rows=50, c=2048, d=2, seed=7)
    _leaf_equal(dev, args, cscale, 18)


@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "int8"])
def test_leaf_kernel_edge_rows(dev, sdt):
    """A row with every candidate masked, rows of duplicated candidates
    (equal sq, ordered by slot), C = 1, and rows whose bases alternate
    between 16-byte aligned and not (C = 70 at D = 2) in one grid."""
    args, cscale = _leaf_case(sdt, rows=9, c=70, d=2, seed=11)
    q, cands, cg, r_sq = args
    cg[0] = -1                        # every candidate masked by gid
    r_sq[1] = -1.0                    # every candidate masked by the gate
    cands[2] = cands[2, :1]           # one point, 70 times: equal sq
    cg[2] = torch.arange(1000, 1070, dtype=torch.int32)
    r_sq[2] = float("inf")
    cands[3, 35:] = cands[3, :35]     # each point twice
    if cscale is not None:
        cscale[2] = cscale[2, :1]
        cscale[3, 35:] = cscale[3, :35]
    want = _leaf_equal(dev, (q, cands, cg, r_sq), cscale, 18)
    assert (want[1][0] == -1).all() and (want[1][1] == -1).all()
    assert torch.equal(want[2][2][:18], torch.arange(18, dtype=torch.int32))
    for k in (1, 5):
        args1, cscale1 = _leaf_case(sdt, rows=33, c=1, d=2, seed=k)
        _leaf_equal(dev, args1, cscale1, k)


def test_launches_are_counted(dev):
    args, _ = _leaf_case("float32", rows=4, c=40)
    before = dict(tk.LAUNCHES)
    tk.leaf_topk_cuda(*[a.to(dev) for a in args], 3)
    tk.leaf_topk_plain(*args, 3)
    assert tk.LAUNCHES["leaf_topk"] == before["leaf_topk"] + 1
    assert tk.LAUNCHES["topk_l2"] == before["topk_l2"]


def _expansion_tol(q, p) -> float:
    """The expansion form's ceiling 8·2⁻²⁴·(max|q|² + max|p|²)."""
    qf, pf = q.float(), p.float()
    return 8 * 2.0**-24 * float((qf * qf).sum(1).max() + (pf * pf).sum(1).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "m,n,d", [(1, 1, 1), (129, 127, 3), (200, 50, 64), (33, 65, 128),
              (70, 130, 17), (64, 256, 2), (129, 193, 40), (300, 517, 13),
              (300, 517, 15)],
)
def test_pairwise_kernel_equals_plain(dev, dtype, m, n, d):
    """The narrow route (D < WIDE_MIN_D) equals the plain version
    bitwise; the wide route's cross term runs on the tensor cores (bf16,
    or three TF32 products for f32), so it is held to the expansion
    form's ceiling, against the plain version and against f64."""
    rng = np.random.default_rng(m * 7 + n + d)
    q = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(dtype)
    p = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)
    p[: min(n, m)] = q[: min(n, m)]  # zero distances: the clamp is exercised
    want = pw.pairwise_plain(q, p)
    got = pw.pairwise_cuda(q.to(dev), p.to(dev)).cpu()
    if pw.route(d, q.element_size()) == "cuda_core":
        assert torch.equal(got, want)
        return
    tol = _expansion_tol(q, p)
    q64, p64 = q.double(), p.double()
    exact = ((q64[:, None, :] - p64[None, :, :]) ** 2).sum(-1)
    assert float((got - want).abs().max()) <= tol
    assert float((got.double() - exact).abs().max()) <= tol
    assert (got >= 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pairwise_routes(dev, dtype):
    """Both routes at one small D (the route-threshold measurement forces
    them so), the route names, and WIDE_MIN_D == the source's."""
    from repro_torch.kernels import cuda_lib

    assert cuda_lib.library().pairwise_sq_l2_wide_min_d() == pw.WIDE_MIN_D
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((300, 7)).astype(np.float32)).to(dtype)
    p = torch.from_numpy(rng.standard_normal((1000, 7)).astype(np.float32)).to(dtype)
    want = pw.pairwise_plain(q, p)
    wide = pw.route(pw.WIDE_MIN_D, q.element_size())
    assert wide == ("wgmma_bf16" if dtype == torch.bfloat16 else "wgmma_tf32x3")
    narrow = pw.pairwise_cuda(q.to(dev), p.to(dev), route_name="cuda_core")
    assert torch.equal(narrow.cpu(), want)
    got = pw.pairwise_cuda(q.to(dev), p.to(dev), route_name=wide).cpu()
    assert float((got - want).abs().max()) <= _expansion_tol(q, p)
    with pytest.raises(ValueError):
        pw.pairwise_cuda(q.to(dev)[:, :0].contiguous(), p.to(dev)[:, :0].contiguous(),
                         route_name="cuda_core")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "n,d", [(1, 1), (10, 2), (517, 130), (1024, 64), (70_000, 3), (300, 300)]
)
def test_cov_matvec_kernel_equals_plain(dev, dtype, n, d):
    rng = np.random.default_rng(n + d)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32) + 2.0)
    x = x.to(dtype)
    mean = x.to(torch.float32).mean(0)
    w = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    want = cm.cov_matvec_plain(x, mean, w)
    xd, md, wd = x.to(dev), mean.to(dev), w.to(dev)
    got = cm.cov_matvec_cuda(xd, md, wd)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(cm.cov_matvec_cuda(xd, md, wd), got)  # no atomics


def test_primitive_launches_are_counted(dev):
    ops.reset_launch_counts()
    x = torch.rand((300, 3), device=dev)
    ops.lower_bounds(x, x[:7], torch.ones(7, device=dev))
    ops.power_iteration(x, iters=5, generator=torch.Generator(device=dev).manual_seed(0))
    ops.pairwise_sq_l2(x.cpu(), x[:7].cpu())  # plain version: not counted
    counts = ops.launch_counts()
    # two device launches per cov_matvec call: partials, then the reduction
    assert counts["pairwise_sq_l2"] == 1 and counts["cov_matvec"] == 2 * 5
