"""The port's distributed static index (`core/distributed.py`) held
against the reference's, on device "cpu".

The reference's `tests/test_distributed_index.py` input: 4,000 × 3
normal points (`numpy.random.default_rng(0)`), 32 queries, k = 8,
r = 1.0, leaf size 16; the brute baseline over 3,998 points, so the
padded slots' gid -1 mask is exercised.

  * Port: 4 shards (`convert.sharded_index_from_reference` over the
    reference's per-shard trees, split as its `build_sharded` splits).
  * Reference: `distributed.constrained_knn` and `brute_constrained_knn`
    on a 1-device mesh, in process (one shard: the host has one JAX
    device). Both compute the exact global constrained k-NN, so the
    answers agree: ids equal; tree distances within rtol 1e-6, brute
    distances (both packages score in the expansion form q²+p²−2qp,
    rounded differently) within 8·2⁻²⁴·(|q|²+|p|²) on the square. Both
    are also held against `core/brute.constrained_knn`.

The per-shard trees come from the reference's host builder: its JAX
builder compiles for tens of seconds on the CPU, and the builder never
changes an exact answer (the port's own builders are held to the brute
oracle below).
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import TreeSpec as JTreeSpec
from repro.core import brute
from repro.core import build_host as jbuild_host
from repro.core import distributed as jdist
from repro_torch import convert
from repro_torch.core import TreeSpec
from repro_torch.core import distributed

K, R = 8, 1.0


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((4000, 3))
    queries = rng.standard_normal((32, 3))
    return pts, queries


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.asarray(jax.devices()[:1]), ("data",))


def _reference_index(pts, n_shards, mesh):
    """The reference's `ShardedIndex` as its `build_sharded` splits the
    points (the last shard takes the rest), trees by its host builder."""
    spec = JTreeSpec.ballstar(leaf_size=16)
    n = len(pts)
    per = n // n_shards
    trees, offsets = [], []
    for s in range(n_shards):
        lo = s * per
        hi = n if s == n_shards - 1 else lo + per
        trees.append(jbuild_host.build(pts[lo:hi], spec))
        offsets.append(lo)
    return jdist.ShardedIndex(
        mesh=mesh,
        trees=trees,
        stacked=jdist._stack_trees(trees),
        stack_size=max(int(t.leaf_depths().max()) for t in trees) + 3,
        shard_offsets=np.asarray(offsets, np.int64),
    )


def _hold_to_brute(pts, queries, idx, dist):
    """ids == the f64 brute oracle's (as sets, as the reference's test
    holds them), distances within its rtol 1e-4."""
    for i in range(len(queries)):
        bi, bd = brute.constrained_knn(pts, queries[i], K, R)
        got = idx[i][idx[i] >= 0]
        assert np.array_equal(np.sort(got), np.sort(bi)), (i, got, bi)
        np.testing.assert_allclose(dist[i][: len(bd)], bd, rtol=1e-4, atol=1e-5)


def _expansion_close(dp, dj, q, p):
    return abs(dp * dp - dj * dj) <= 8 * 2.0**-24 * (float(q @ q) + float(p @ p))


def test_sharded_tree_matches_reference(data, mesh):
    pts, queries = data
    port_index = convert.sharded_index_from_reference(
        _reference_index(pts, 4, mesh), device="cpu"
    )
    assert port_index.n_shards == 4
    assert port_index.shard_offsets.tolist() == [0, 1000, 2000, 3000]
    idx, dist = distributed.constrained_knn(port_index, queries, K, R)
    jidx, jdist_ = jdist.constrained_knn(
        _reference_index(pts, 1, mesh), queries, K, R
    )
    np.testing.assert_array_equal(idx, jidx)
    fin = np.isfinite(jdist_)
    np.testing.assert_array_equal(np.isfinite(dist), fin)
    np.testing.assert_allclose(dist[fin], jdist_[fin], rtol=1e-6, atol=0)
    assert fin.any()
    _hold_to_brute(pts, queries, idx, dist)


def test_brute_baseline_matches_reference(data, mesh):
    pts, queries = data
    sub = pts[:3998]  # not a multiple of 4: padded slots carry gid -1
    idx, dist = distributed.brute_constrained_knn(
        sub, "cpu", queries, K, R, n_shards=4
    )
    jidx, jdist_ = jdist.brute_constrained_knn(sub, mesh, queries, K, R)
    np.testing.assert_array_equal(idx, jidx)
    assert (idx >= 0).any() and (idx < len(sub)).all()
    q32, p32 = queries.astype(np.float32), sub.astype(np.float32)
    for i in range(len(queries)):
        for j, g in enumerate(idx[i]):
            if g < 0:
                assert np.isinf(dist[i, j]) and np.isinf(jdist_[i, j])
                continue
            assert _expansion_close(float(dist[i, j]), float(jdist_[i, j]),
                                    q32[i].astype(np.float64),
                                    p32[g].astype(np.float64))
    _hold_to_brute(sub, queries, idx, dist)


@pytest.mark.parametrize("backend", ["torch", "host"])
def test_build_sharded_is_exact(data, backend):
    """The port's own builders, 4 shards on the CPU: the reference's
    split, its pad fills, and answers equal to the brute oracle."""
    pts, queries = data
    index = distributed.build_sharded(
        pts, "cpu", TreeSpec.ballstar(leaf_size=16), n_shards=4,
        backend=backend,
    )
    assert index.shard_offsets.tolist() == [0, 1000, 2000, 3000]
    (grp,) = index.groups  # one device: the four shards stack into one walk
    assert grp.shards == (0, 1, 2, 3)
    n_nodes = [t.n_nodes for t in index.trees]
    st = grp.stacked
    assert st.center.shape[:2] == (4, max(n_nodes))
    for s, t in enumerate(index.trees):
        pad = slice(t.n_nodes, None)
        assert bool((st.center[s, pad] == 1e30).all())
        assert bool((st.radius[s, pad] == 0).all())
        assert bool((st.child_l[s, pad] == -1).all())
        assert bool((st.leaf_of_node[s, pad] == -1).all())
        assert bool((st.leaf_index[s, t.n_leaves:] == -1).all())
        assert int(grp.gids[s, 0]) == 1000 * s
    idx, dist = distributed.constrained_knn(index, queries, K, R)
    _hold_to_brute(pts, queries, idx, dist)


def test_round_robin_placement():
    placed = distributed._placement(["cpu", "meta"], 5)
    assert [d.type for d in placed] == ["cpu", "meta", "cpu", "meta", "cpu"]
    assert distributed._placement("cpu", None) == [torch.device("cpu")]
    with pytest.raises(ValueError):
        distributed.device_list([])


def test_no_card_raises(data):
    """No fallback hides the device: asked for the card where there is
    none, the sharded entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path cannot be shown")
    pts, queries = data
    with pytest.raises((RuntimeError, AssertionError)):
        distributed.build_sharded(pts, "cuda", n_shards=4)
    with pytest.raises((RuntimeError, AssertionError)):
        distributed.brute_constrained_knn(pts, "cuda", queries, K, R, n_shards=4)
