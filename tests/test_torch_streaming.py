"""The port's StreamingIndex (device cpu) held against the reference's.

One seeded op sequence — bulk_load, adds that seal the arena and
trigger tier merges, deletes, a full compaction — goes into
`repro.index.StreamingIndex` and `repro_torch.index.StreamingIndex`
(default bf16 storage in both). After each query batch:

  * gids equal between the two packages, in order;
  * both equal the brute oracle (`repro.core.brute`) over the live set;
  * distances within rtol 1e-6 — except hits served by the delta arena,
    which both packages score in the expansion form q²+p²−2qp: those are
    held to its cancellation bound, 8·2⁻²⁴·(|q|²+|p|²) on the square.

Also: an all-tombstoned snapshot short-circuits on the host (zero
dispatches), and a snapshot taken before a mutation answers as before
(copy-on-write isolation).
"""
import numpy as np
import pytest
import torch

from repro.core import TreeSpec as JTreeSpec
from repro.core import brute
from repro.index import StreamingConfig as JConfig
from repro.index import StreamingIndex as JIndex
from repro_torch.core import TreeSpec
from repro_torch.index import StreamingConfig, StreamingIndex
from repro_torch.query import QuerySpec, engine

K, R, DIM = 5, 0.5, 2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair():
    # the reference's host builder: builds are not under test here, and
    # the builder never changes exact search results
    ref = JIndex(JConfig(dim=DIM, delta_capacity=64, merge_factor=3,
                         spec=JTreeSpec.ballstar(leaf_size=8),
                         backend="host"))
    port = StreamingIndex(StreamingConfig(
        dim=DIM, delta_capacity=64, merge_factor=3,
        spec=TreeSpec.ballstar(leaf_size=8), device="cpu"))
    return ref, port


def _close(dp, dj, q, pts_of):
    """rtol 1e-6, or within the expansion-form bound on the square."""
    if abs(dp - dj) <= 1e-6 * dj:
        return True
    bound = 8 * 2.0**-24 * (float(q @ q) + float(pts_of @ pts_of))
    return abs(dp * dp - dj * dj) <= bound


def _check(ref, port, queries):
    a = ref.constrained_knn(queries, K, R)
    b = port.constrained_knn(queries, K, R)
    assert np.array_equal(a.gids, b.gids)
    pts, gids = port.live_points()
    rp, rg = ref.live_points()
    assert np.array_equal(gids, rg) and np.array_equal(pts, rp)
    pos = {int(g): i for i, g in enumerate(gids)}
    for i, q in enumerate(queries):
        bi, bd = brute.constrained_knn(pts, q, K, R)
        row = b.gids[i][b.gids[i] >= 0]
        assert set(row.tolist()) == set(gids[bi].tolist())
        for j, g in enumerate(row):
            p = pts[pos[int(g)]].astype(np.float64)
            assert _close(float(b.distances[i, j]), float(a.distances[i, j]),
                          q.astype(np.float64), p)
    return b


def test_op_sequence_matches_reference():
    rng = np.random.default_rng(0)
    ref, port = _pair()
    first = rng.standard_normal((150, DIM)).astype(np.float32)
    assert np.array_equal(ref.bulk_load(first), port.bulk_load(first))
    queries = rng.standard_normal((8, DIM)).astype(np.float32)
    _check(ref, port, queries)
    for step in range(6):
        pts = rng.standard_normal((int(rng.integers(30, 80)), DIM))
        pts = pts.astype(np.float32)
        assert np.array_equal(ref.add(pts), port.add(pts))
        if step % 2 == 1:
            victims = rng.choice(port.live_gids(), size=15, replace=False)
            assert ref.delete(victims) == port.delete(victims)
        _check(ref, port, queries)
    assert port.stats()["seals"] >= 3 and port.stats()["tiered_merges"] >= 1
    assert port.stats()["n_segments"] == ref.stats()["n_segments"]
    ref.compact()
    port.compact()
    assert port.stats()["n_segments"] == 1 and port.delta.size == 0
    _check(ref, port, queries)


def test_snapshot_isolation():
    rng = np.random.default_rng(1)
    port = StreamingIndex(StreamingConfig(
        dim=DIM, delta_capacity=64, spec=TreeSpec.ballstar(leaf_size=8),
        device="cpu"))
    port.bulk_load(rng.standard_normal((120, DIM)))
    port.add(rng.standard_normal((40, DIM)))
    queries = rng.standard_normal((6, DIM)).astype(np.float32)
    snap = port.snapshot()
    before = engine.execute(snap, queries, QuerySpec(k=K, radius=R))
    delta_points = snap.delta_points.clone()
    # mutate every kind of holder: delta tombstones, segment tombstones,
    # appends that seal the arena, a merge
    port.delete(np.arange(0, 160, 3))
    port.add(rng.standard_normal((90, DIM)))
    after = engine.execute(snap, queries, QuerySpec(k=K, radius=R))
    assert np.array_equal(before.gids, after.gids)
    assert np.array_equal(before.distances, after.distances)
    assert torch.equal(snap.delta_points, delta_points)
    now = port.constrained_knn(queries, K, R)
    assert not np.array_equal(now.gids, before.gids)


def test_all_tombstoned_short_circuits():
    rng = np.random.default_rng(2)
    port = StreamingIndex(StreamingConfig(
        dim=DIM, delta_capacity=32, spec=TreeSpec.ballstar(leaf_size=8),
        device="cpu"))
    gids = np.concatenate([port.bulk_load(rng.standard_normal((50, DIM))),
                           port.add(rng.standard_normal((10, DIM)))])
    port.delete(gids)
    before = engine.dispatch_count()
    res = port.constrained_knn(rng.standard_normal((3, DIM)), K, R)
    assert engine.dispatch_count() == before
    assert (res.gids == -1).all() and np.isinf(res.distances).all()
