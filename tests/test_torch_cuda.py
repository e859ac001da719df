"""The hand-written CUDA kernels == their plain PyTorch versions, bitwise.

Marked `cuda`: skipped where there is no card. On a machine with one
(which has no JAX, and this repo's tests/conftest.py imports it):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The plain versions repeat each kernel's arithmetic operation by
operation (explicitly rounded, uncontracted f32), so sq, gid and slot
must all be equal — no tolerance.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import quantize
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


def test_launches_are_counted(dev):
    args, _ = _leaf_case("float32", rows=4, c=40)
    before = dict(tk.LAUNCHES)
    tk.leaf_topk_cuda(*[a.to(dev) for a in args], 3)
    tk.leaf_topk_plain(*args, 3)
    assert tk.LAUNCHES["leaf_topk"] == before["leaf_topk"] + 1
    assert tk.LAUNCHES["topk_l2"] == before["topk_l2"]
