"""The hand-written CUDA kernels == their plain PyTorch versions, bitwise.

Marked `cuda`: skipped where there is no card. On a machine with one
(which has no JAX, and this repo's tests/conftest.py imports it):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The plain versions repeat each kernel's arithmetic operation by
operation (explicitly rounded, uncontracted f32, in the kernel's order
of sums), so every output must be equal — sq, gid and slot of the top-k
kernels (whose (sq, slot) selection does not depend on how the arena
is split), the pairwise matrix on its narrow route, the covariance
matvec (one launch, its last block folding the partials) — no
tolerance. The one exception is the pairwise kernel's wide route
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


def _arena_case(m, n, d=2, seed=0, r=0.6):
    """Queries among the arena's points, every 7th slot tombstoned."""
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    q = torch.from_numpy(
        (rng.standard_normal((m, d)) * 1.1).astype(np.float32))
    g = torch.arange(n, dtype=torch.int32)
    g[::7] = -1
    return q, p, g, tk.radius_sq_upper(torch.full((m,), r))


def _topk_equal(dev, q, p, g, r_sq, k):
    want = tk.topk_plain(q, p, g, r_sq, k)
    got = tk.topk_cuda(q.to(dev), p.to(dev), g.to(dev), r_sq.to(dev), k)
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)
    return want


@pytest.mark.parametrize("m,n", [(64, 4096), (5300, 4096), (3, 1), (70, 4097)])
def test_topk_kernel_split_shapes(dev, m, n):
    """The main path's shapes (Q = 64 splits the arena 16 ways, Q = 5,300
    gives each warp four queries over two splits), one point, and ragged
    query groups and splits."""
    _topk_equal(dev, *_arena_case(m, n, seed=m + n), 10)


@pytest.mark.parametrize("k", [1, 10, 32, 33, 64])
def test_topk_kernel_k(dev, k):
    """k <= 32: the register list and the split merge; 33 and 64: the
    shared-memory list over one split. Both query counts per warp."""
    for m in (64, 300):
        want = _topk_equal(dev, *_arena_case(m, 3000, seed=k, r=0.9), k)
        assert (want[1] >= 0).any()


def test_topk_kernel_dead_and_sparse(dev):
    """An all-tombstoned arena gives the all-padding answer; a small
    radius leaves rows with fewer than k passing points."""
    q, p, g, r_sq = _arena_case(64, 4096, seed=3)
    want = _topk_equal(dev, q, p, torch.full_like(g, -1), r_sq, 10)
    assert (want[1] == -1).all() and torch.isinf(want[0]).all()
    r_sq = tk.radius_sq_upper(torch.full((64,), 0.05))
    want = _topk_equal(dev, q, p, g, r_sq, 10)
    live = (want[1] >= 0).sum(1)
    assert (live < 10).any() and (live > 0).any()


def _cov_case(n, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        (rng.standard_normal((n, d)) * np.linspace(3, 1, d) + 2.0).astype(np.float32))
    x = x.to(dtype)
    mean = x.to(torch.float32).mean(0)
    w = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    return x, mean, w


def test_ticket_counters_two_streams_and_graphs(dev):
    """The last-block tickets: calls on two streams at once, and calls
    captured in a CUDA graph (counters made inside the capture) and
    replayed twice, all equal to the plain versions."""
    x, mean, w = _cov_case(70_000, 5, torch.float32, seed=1)
    q, p, g, r_sq = _arena_case(64, 4096, seed=2)
    want_y = cm.cov_matvec_plain(x, mean, w)
    want_t = tk.topk_plain(q, p, g, r_sq, 10)
    args_c = [t.to(dev) for t in (x, mean, w)]
    args_t = [t.to(dev) for t in (q, p, g, r_sq)]
    torch.cuda.synchronize()
    outs = []
    for stream in (torch.cuda.Stream(), torch.cuda.Stream()):
        with torch.cuda.stream(stream):
            for _ in range(3):
                outs.append((cm.cov_matvec_cuda(*args_c),
                             tk.topk_cuda(*args_t, 10)))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    with torch.cuda.graph(graph, stream=side):
        captured = (cm.cov_matvec_cuda(*args_c), tk.topk_cuda(*args_t, 10))
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(captured)
    for y, (sq, gid, slot) in outs:
        assert torch.equal(y.cpu(), want_y)
        for a, b in zip((sq, gid, slot), want_t):
            assert torch.equal(a.cpu(), b)


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
    q, p, g, r_sq = _arena_case(64, 500)
    tk.topk_cuda(q.to(dev), p.to(dev), g.to(dev), r_sq.to(dev), 5)
    # the |p|² pre-pass and the split scan
    assert tk.LAUNCHES["topk_l2"] == before["topk_l2"] + 2
    assert tk.launches_by_q()[64] >= 2


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
    "n,d", [(1, 1), (10, 2), (517, 130), (1024, 64), (70_000, 3), (300, 300),
            (257, 3), (500_000, 2), (100_000, 64), (33, 2048)]
)
def test_cov_matvec_kernel_equals_plain(dev, dtype, n, d):
    """Edge shapes and chip_smoke's two: one device launch a call,
    bitwise equal to the plain version and across two runs."""
    x, mean, w = _cov_case(n, d, dtype, seed=n + d)
    want = cm.cov_matvec_plain(x, mean, w)
    xd, md, wd = x.to(dev), mean.to(dev), w.to(dev)
    before = cm.LAUNCHES["cov_matvec"]
    got = cm.cov_matvec_cuda(xd, md, wd)
    assert cm.LAUNCHES["cov_matvec"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(cm.cov_matvec_cuda(xd, md, wd), got)  # no atomics


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(33, 2049), (4096, 2049), (300, 12032),
                                 (4096, 12032), (3, 60_000)])
def test_cov_matvec_wide_rows_equal_plain(dev, dtype, n, d):
    """Rows wider than 2,048 take the wide route (one row a warp, the
    column sums in shared memory, or past 57,344 columns in the block's
    partial row): one launch, bitwise equal to the plain version and
    across two runs, and power_iteration runs on them."""
    assert cm.route(d) == "wide" and cm.route(2048) == "tile"
    x, mean, w = _cov_case(n, d, dtype, seed=n + d)
    want = cm.cov_matvec_plain(x, mean, w)
    xd, md, wd = x.to(dev), mean.to(dev), w.to(dev)
    before = cm.LAUNCHES["cov_matvec"]
    got = cm.cov_matvec_cuda(xd, md, wd)
    assert cm.LAUNCHES["cov_matvec"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(cm.cov_matvec_cuda(xd, md, wd), got)  # no atomics
    v = ops.power_iteration(xd, iters=2,
                            generator=torch.Generator(device=dev).manual_seed(0))
    assert v.shape == (d,) and bool(torch.isfinite(v).all())


def test_primitive_launches_are_counted(dev):
    ops.reset_launch_counts()
    x = torch.rand((300, 3), device=dev)
    ops.lower_bounds(x, x[:7], torch.ones(7, device=dev))
    ops.power_iteration(x, iters=5, generator=torch.Generator(device=dev).manual_seed(0))
    ops.pairwise_sq_l2(x.cpu(), x[:7].cpu())  # plain version: not counted
    counts = ops.launch_counts()
    # one device launch per cov_matvec call (the last block folds)
    assert counts["pairwise_sq_l2"] == 1 and counts["cov_matvec"] == 5


def _card_index(dev, tmp_path=None, seed=3):
    """A small streaming index on the card: 600 sealed points in 8-D plus
    50 in the delta arena, a tenth of them deleted (WAL in `tmp_path`)."""
    from repro_torch.index import StreamingConfig, StreamingIndex

    rng = np.random.default_rng(seed)
    wal = None if tmp_path is None else str(tmp_path / "card.wal")
    idx = StreamingIndex(StreamingConfig(dim=8, delta_capacity=128,
                                         device=str(dev), wal_path=wal))
    g = idx.add(rng.normal(size=(600, 8)).astype(np.float32))
    idx.flush()
    idx.add(rng.normal(size=(50, 8)).astype(np.float32))
    idx.delete(g[::10])
    return idx, rng.normal(size=(64, 8)).astype(np.float32)


def test_wal_recovery_on_the_card_is_bitwise(dev, tmp_path):
    """Checkpoint + WAL tail on the card: the recovered index (segments
    rebuilt by the device builder) answers bitwise as before the close."""
    idx, q = _card_index(dev, tmp_path)
    assert idx.checkpoint()
    idx.add(np.random.default_rng(4).normal(size=(30, 8)).astype(np.float32))
    want = idx.constrained_knn(q, 5, 2.5)
    idx.close()
    from repro_torch.index import StreamingIndex

    rec = StreamingIndex(idx.config)
    got = rec.constrained_knn(q, 5, 2.5)
    np.testing.assert_array_equal(got.gids, want.gids)
    np.testing.assert_array_equal(got.distances, want.distances)
    np.testing.assert_array_equal(rec.live_gids(), idx.live_gids())
    rec.close()


def test_frontend_over_card_index_matches_direct(dev):
    """4 clients x 16 synchronous requests through the frontend: every
    reply equals the direct search bitwise, and the dispatches went
    through both read-path kernels."""
    import threading

    from repro_torch.serve.frontend import FrontendConfig, SearchFrontend

    idx, q = _card_index(dev)
    fe = SearchFrontend(idx, FrontendConfig(k=5, radius=2.5, max_batch=16))
    replies = [None] * len(q)
    with fe:
        ops.reset_launch_counts()

        def client(c):
            for i in range(c * 16, (c + 1) * 16):
                replies[i] = fe.search(q[i], timeout=120)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)
    counts = ops.launch_counts()
    assert counts["leaf_topk"] > 0 and counts["topk_l2"] > 0
    direct = idx.constrained_knn(q, 5, 2.5)
    for i, reply in enumerate(replies):
        np.testing.assert_array_equal(reply.gids, direct.gids[i])
        np.testing.assert_array_equal(reply.distances, direct.distances[i])


def _sharded_pair(devices, seed=11):
    """A 4-shard index (shards round-robin over `devices`) and a
    single-device index fed the same ops: 1,500 points in 8-D in odd
    batches, a tenth deleted, then flushed."""
    from repro_torch.index import (
        ShardedStreamingIndex,
        StreamingConfig,
        StreamingIndex,
    )

    mk = lambda: StreamingConfig(dim=8, delta_capacity=128,  # noqa: E731
                                 device=str(devices[0]))
    sh = ShardedStreamingIndex(mk(), n_shards=4, devices=devices)
    ref = StreamingIndex(mk())
    rng = np.random.default_rng(seed)
    for n in (301, 499, 77, 623):
        pts = rng.normal(size=(n, 8)).astype(np.float32)
        np.testing.assert_array_equal(sh.add(pts), ref.add(pts))
    dead = rng.choice(ref.live_gids(), size=150, replace=False)
    assert sh.delete(dead) == ref.delete(dead) == 150
    sh.flush()
    ref.flush()
    return sh, ref, rng.normal(size=(64, 8)).astype(np.float32)


def test_sharded_on_one_card_equals_single_device(dev):
    """4 shards on one card: after a flush, answers bitwise equal to the
    single-device index, through both read-path kernels."""
    sh, ref, q = _sharded_pair([dev])
    assert {d.type for d in sh.devices} == {"cuda"}
    ops.reset_launch_counts()
    got = sh.constrained_knn(q, 5, 2.5)
    assert ops.launch_counts()["leaf_topk"] > 0
    want = ref.constrained_knn(q, 5, 2.5)
    np.testing.assert_array_equal(got.gids, want.gids)
    np.testing.assert_array_equal(got.distances, want.distances)
    assert not got.partial and (got.gids >= 0).any()


def test_sharded_brute_kernel_equals_plain(dev, monkeypatch):
    """`brute_constrained_knn` at a few thousand points a shard: the
    answer through the topk_l2 kernel equals the same call with the
    kernel's plain version in its place, on the card, bitwise."""
    from repro_torch.core import distributed

    rng = np.random.default_rng(12)
    pts = rng.normal(size=(13_998, 3)).astype(np.float32)
    q = rng.normal(size=(300, 3)).astype(np.float32)
    ops.reset_launch_counts()
    gi, gd = distributed.brute_constrained_knn(pts, dev, q, 10, 0.4, n_shards=4)
    assert ops.launch_counts()["topk_l2"] == 2 * 4
    monkeypatch.setattr(tk, "topk_cuda", tk.topk_plain)
    wi, wd = distributed.brute_constrained_knn(pts, dev, q, 10, 0.4, n_shards=4)
    assert ops.launch_counts()["topk_l2"] == 2 * 4
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    assert (gi >= 0).any()


def test_sharded_across_cards_equals_single_device(dev):
    """Shards round-robin over two cards, the fold on the first: bitwise
    equal to the single-device index."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    sh, ref, q = _sharded_pair(devs)
    assert [d.index for d in sh.devices] == [0, 1, 0, 1]
    got = sh.constrained_knn(q, 5, 2.5)
    want = ref.constrained_knn(q, 5, 2.5)
    np.testing.assert_array_equal(got.gids, want.gids)
    np.testing.assert_array_equal(got.distances, want.distances)


# --------------------------------------------------------------------- #
# the kNN-LM path: the read-path kernels at D = 32 (the projected keys,
# the generic VD = 0 routes), and the model stack on the card
# --------------------------------------------------------------------- #
def _d32_leaf_case(sdt, rows=64, c=512, seed=21):
    """Rows of 32-d candidates around their queries (~1.1 apart), 20%
    dead slots, radii of 0.8-1.4: some pass the gate, some do not."""
    rng = np.random.default_rng(seed)
    d = 32
    q = rng.standard_normal((rows, d)).astype(np.float32)
    cands = torch.from_numpy(
        (q[:, None, :] + 0.2 * rng.standard_normal((rows, c, d))).astype(np.float32))
    cg = rng.permutation(rows * c).reshape(rows, c).astype(np.int32)
    cg[rng.random((rows, c)) < 0.2] = -1
    r = torch.from_numpy(rng.uniform(0.8, 1.4, rows).astype(np.float32))
    store, scale, _ = quantize.quantize_leaves(cands, sdt)
    cscale = None
    if scale is not None:
        cscale = scale[:, None].expand(rows, c).contiguous()
    store = cands if store is None else store
    return (torch.from_numpy(q), store, torch.from_numpy(cg),
            tk.radius_sq_upper(r)), cscale


@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("rows,c,k", [(64, 512, 16), (4, 64, 16), (3, 300, 40)])
def test_leaf_kernel_d32_equals_plain(dev, sdt, rows, c, k):
    args, cscale = _d32_leaf_case(sdt, rows, c)
    want = _leaf_equal(dev, args, cscale, k)
    assert (want[1] >= 0).any() and (want[1] < 0).any()


@pytest.mark.parametrize("m,n,k", [(4, 256, 8), (64, 256, 8), (64, 4096, 10),
                                   (5, 300, 40)])
def test_topk_kernel_d32_equals_plain(dev, m, n, k):
    """The delta arena of a kNN-LM datastore (256 slots, 4 queries a
    decode step, k = 8), wider arenas, and the shared-memory list."""
    rng = np.random.default_rng(m * n + k)
    p = torch.from_numpy(rng.standard_normal((n, 32)).astype(np.float32))
    q = p[torch.from_numpy(rng.integers(0, n, m))] + 0.3 * torch.from_numpy(
        rng.standard_normal((m, 32)).astype(np.float32))
    g = torch.arange(n, dtype=torch.int32)
    g[::7] = -1
    r_sq = tk.radius_sq_upper(torch.full((m,), 6.0))
    want = _topk_equal(dev, q.contiguous(), p, g, r_sq, k)
    assert (want[1] >= 0).any()


def test_model_on_the_card_matches_the_cpu(dev):
    """The reduced qwen2-0.5b, the same weights on the card and on the
    CPU: forward logits, prefill + decode, and greedy generation's
    per-step logits agree within rtol 0.03, atol 0.03 (bf16 products
    summed in another order on each device; 1-2 bf16 ulps expected), and
    the tokens agree up to each row's first close call (top-2 margin
    under twice the row's largest difference)."""
    import copy

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine

    cfg = configs.get("qwen2-0.5b").reduced()
    cpu = M.init_params(cfg, 3, "cpu")
    card = copy.deepcopy(cpu).to(dev)
    tol = dict(rtol=0.03, atol=0.03)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32))
    want, _ = M.forward(cpu, x)
    got, _ = M.forward(card, x.to(dev))
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().numpy(), **tol)
    lw, cw = M.prefill(cpu, x[:, :36], 40)
    lg, cg = M.prefill(card, x[:, :36].to(dev), 40)
    for i in range(4):
        np.testing.assert_allclose(lg[:, -1].float().cpu().numpy(),
                                   lw[:, -1].float().numpy(), **tol)
        tok = x[:, 36 + i:37 + i]
        lw, cw = M.decode_step(cpu, cw, tok, 36 + i)
        lg, cg = M.decode_step(card, cg, tok.to(dev), 36 + i)
    prompt = x[:, :16].numpy()
    tw, hw = Engine(cfg, cpu, 32, device="cpu").generate(prompt, 8, capture_hidden=True)
    tg, hg = Engine(cfg, card, 32, device=dev).generate(prompt, 8, capture_hidden=True)
    np.testing.assert_allclose(hg[0], hw[0], **tol)
    for b in range(2):
        for i in range(8):
            top2 = np.sort(hw[i][b])[-2:]
            if top2[1] - top2[0] <= 2 * np.abs(hg[i][b] - hw[i][b]).max():
                break
            assert tg[b, i] == tw[b, i]
            np.testing.assert_allclose(hg[i][b], hw[i][b], **tol)


def test_moe_model_on_the_card_matches_the_cpu(dev):
    """The reduced deepseek-v2-lite (MLA mixers, a dense first layer, two
    MoE layers) with deepseek's own routing — 64 experts, top-6, 2 shared
    — at the published capacity factor 1.25, the same weights on the card
    and on the CPU. One 63-token sequence is one dispatch group with
    C = 8, so assignments drop. Forward, prefill(63) and 3 decode steps:
    every MoE call chooses the same experts and drops the same count on
    both, and the logits agree within rtol 0.03, atol 0.03 (bf16 products
    summed in another order on each device, as for the dense model)."""
    import copy
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import moe

    cfg = dataclasses.replace(
        configs.get("deepseek-v2-lite-16b").reduced(), n_experts=64, top_k=6,
        n_shared=2, capacity_factor=1.25)
    cpu = M.init_params(cfg, 3, "cpu")
    card = copy.deepcopy(cpu).to(dev)
    tol = dict(rtol=0.03, atol=0.03)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 66)).astype(np.int32))

    def run(model, device):
        with moe.routing_trace(model) as calls:
            out = [M.forward(model, x[:, :63].to(device))[0]]
            logits, cache = M.prefill(model, x[:, :63].to(device), 66)
            out.append(logits)
            for i in range(3):
                tok = x[:, 63 + i:64 + i].to(device)
                logits, cache = M.decode_step(model, cache, tok, 63 + i)
                out.append(logits)
        return out, [(n, e.cpu(), int(d.sum())) for n, _, e, d in calls]

    want, want_calls = run(cpu, "cpu")
    got, got_calls = run(card, dev)
    assert len(got_calls) == len(want_calls) == 2 * 5
    assert sum(d for _, _, d in want_calls) > 0
    for (n, e, d), (wn, we, wd) in zip(got_calls, want_calls):
        assert n == wn and d == wd and torch.equal(e, we)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(), w.float().numpy(), **tol)


# -- the top-k kernels' sort route (k above the list route's 1,024) ---------------
@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("rows,c,k", [(9, 1200, 1025), (9, 1600, 1500),
                                      (5, 3000, 4096), (3, 40000, 1500)])
def test_leaf_kernel_sort_route_equals_plain(dev, sdt, rows, c, k):
    """k' = 1,025 is a bf16 query's k = 1,017 plus the slack of 8; k =
    4,096 above C pads; C = 40,000 keys do not fit shared memory and
    take the global scratch."""
    assert tk.route(k) == "sort"
    args, cscale = _leaf_case(sdt, rows=rows, c=c, seed=k)
    want = tk.leaf_topk_plain(*args, k, cscale=cscale)
    before = tk.LAUNCHES["leaf_topk"]
    got = tk.leaf_topk_cuda(
        *[a.to(dev) for a in args], k,
        cscale=None if cscale is None else cscale.to(dev),
    )
    assert tk.LAUNCHES["leaf_topk"] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)
    assert (want[1] >= 0).sum() > 0


@pytest.mark.parametrize("n,d", [(5000, 2), (40000, 5)])
@pytest.mark.parametrize("k", [1025, 1500, 4096])
def test_topk_kernel_sort_route_equals_plain(dev, n, d, k):
    rng = np.random.default_rng(n + k)
    q = torch.from_numpy(rng.standard_normal((37, d)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    g = np.where(rng.random(n) < 0.2, -1, np.arange(n)).astype(np.int32)
    g = torch.from_numpy(g)
    r_sq = tk.radius_sq_upper(torch.full((37,), 2.5))
    want = tk.topk_plain(q, p, g, r_sq, k)
    before = tk.LAUNCHES["topk_l2"]
    got = tk.topk_cuda(q.to(dev), p.to(dev), g.to(dev), r_sq.to(dev), k)
    assert tk.LAUNCHES["topk_l2"] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


def test_streaming_query_large_k_card_equals_cpu(dev):
    """k = 2,000 through the streaming index: the fused traversal's leaf
    launch at bf16 k' = 2,008 and the delta arena's scan both take the
    sort route on the card, and the answer equals the CPU's."""
    from repro_torch.core import TreeSpec
    from repro_torch.data.synthetic import highleyman, uniform_queries
    from repro_torch.index import StreamingConfig, StreamingIndex

    pts = highleyman(53_000, seed=0)
    queries = uniform_queries(pts, 64, seed=1)
    r = 0.03 * float(np.linalg.norm(pts.max(0) - pts.min(0)))
    out = []
    for device in ("cpu", dev):
        idx = StreamingIndex(StreamingConfig(
            dim=2, delta_capacity=4096, spec=TreeSpec.ballstar(leaf_size=32),
            merge_factor=4, storage_dtype="bfloat16", device=device))
        idx.bulk_load(pts[:50_000])
        idx.add(pts[50_000:])
        ops.reset_launch_counts()
        out.append(idx.constrained_knn(queries, 2000, r))
    routes = tk.launches_by_route()
    assert routes["leaf_topk"]["sort"] >= 1 and routes["topk_l2"]["sort"] >= 1
    cpu, card = out
    np.testing.assert_array_equal(card.gids, cpu.gids)
    np.testing.assert_allclose(card.distances, cpu.distances, rtol=1e-6)
    assert (cpu.gids >= 0).sum() > 0


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One training step of the reduced qwen2-0.5b (q/k/v biases and a
    tied embedding), card against CPU on the same f32 weights and a batch
    of 2 x 48 tokens, through chip_smoke's phase 10 (b) check: the loss
    within rtol 1e-3, each gradient within a relative Frobenius error of
    2e-2 (plus 1e-6 of the global norm), the card's AdamW on the CPU's
    gradients within 1e-5, and each parameter's first update within 1e-2
    over the coordinates whose CPU gradient is at least a tenth of its
    tensor's RMS (the tolerances and their reasons: chip_smoke, where
    `TRAIN_GRAD_RTOL` is set)."""
    import importlib.util
    import pathlib

    from repro_torch import configs

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        out = smoke.train_card_vs_cpu(configs.get("qwen2-0.5b").reduced(), dev,
                                      batch=(2, 48))
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    assert out["opt_rel_err_max"] <= 1e-5 and out["update_rel_err_max"] <= 1e-2
