"""The port's sharded streaming index (`index/sharded.py`) on device "cpu",
held against the reference's and against its own single-device index.

  * Cross-package: one seeded interleave of add / delete / flush (dim 6,
    delta_capacity 48, merge_factor 3, odd batch sizes) through the
    reference's `ShardedStreamingIndex(n_shards=4)` — one JAX device, so
    its host-fold path — and the port's, both on the numpy builder
    (`backend="host"`), then one query batch with every delta arena
    filled: add gids equal, delete counts equal, query ids equal;
    distances within rtol 1e-6, or for hits a delta arena scores (the
    expansion form in both packages, rounded differently) within
    8·2⁻²⁴·(|q|²+|p|²) on the square. The reference answers through its
    classic loop (held bitwise equal to its fused one by its own tests),
    which keeps its first JAX compile short.
  * The reference's own identities, bitwise, inside the port (the device
    builder, `backend="torch"`): sharded == single-device after a flush
    (`tests/test_sharded_streaming.py`'s 4-device oracle), also with a
    fully tombstoned shard; kill-and-recover from the four WALs; the
    4-shard crash sweep of `tests/test_checkpoint_recovery.py`.
  * Failover: the `sharded`-fixture tests of
    `tests/test_fault_injection.py` (the two whose answer stays whole are
    cases of one test).
  * Files: the interleave's 4-shard `wal_dir` (checkpoints and WAL
    tails) written by either package recovers in the other — same global
    ids, same live set, same answer ids.
  * Deferred merges and the background compaction thread, plain and
    4-shard (`tests/test_sharded_streaming.py`'s in-process tests).
"""
import os
import time

import numpy as np
import pytest
import torch

from repro.index import StreamingConfig as JConfig
from repro.index.sharded import ShardedStreamingIndex as JSharded
from repro.query import engine as jengine
from repro_torch import obs
from repro_torch.index import (
    FailoverPolicy,
    ShardedStreamingIndex,
    StreamingConfig,
    StreamingIndex,
    data_devices,
    faults,
)
from repro_torch.index import wal as wal_mod
from repro_torch.index.faults import InjectedFault

DIM, K, R = 6, 5, 2.5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(**kw):
    kw = {"dim": DIM, "delta_capacity": 48, "merge_factor": 3, **kw}
    return StreamingConfig(device="cpu", **kw)


def _close(dp, dj, q, p):
    """rtol 1e-6, or within the expansion-form bound on the square."""
    if abs(dp - dj) <= 1e-6 * dj:
        return True
    bound = 8 * 2.0**-24 * (float(q @ q) + float(p @ p))
    return abs(dp * dp - dj * dj) <= bound


def _same(a, b, tag=""):
    np.testing.assert_array_equal(a.gids, b.gids, err_msg=tag)
    np.testing.assert_array_equal(a.distances, b.distances, err_msg=tag)


# -- cross-package ------------------------------------------------------------
@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """One seeded interleave through both packages' 4-shard indexes, each
    writing a WAL directory (both checkpointed after the first flush
    barrier), the write path held equal as it goes (add gids, delete
    counts); it ends with every delta arena filled and one query batch
    answered by both, then both are closed. The reference answers through
    its classic loop (the patch lasts the module: its recovery answers
    too), and is queried once — its first call of each shape compiles."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jengine, "_fused_enabled", lambda: False)
    root = tmp_path_factory.mktemp("cross")
    dirs = {"reference": str(root / "reference"), "port": str(root / "port")}
    ref = JSharded(JConfig(dim=DIM, delta_capacity=48, merge_factor=3,
                           backend="host"), n_shards=4, wal_dir=dirs["reference"])
    port = ShardedStreamingIndex(_cfg(backend="host"), n_shards=4,
                                 wal_dir=dirs["port"])
    rng = np.random.default_rng(5)
    coords, live = {}, []

    def add(n):
        pts = rng.normal(size=(n, DIM)).astype(np.float32)
        g1, g2 = port.add(pts), ref.add(pts)
        np.testing.assert_array_equal(g1, g2)
        coords.update(zip(g1.tolist(), pts.astype(np.float64)))
        live.extend(g1.tolist())

    for step in range(12):
        op = int(rng.integers(0, 3))
        if op <= 1 or not live:
            add(int(rng.integers(1, 60)) | 1)  # odd: shards stay uneven
        else:
            m = int(rng.integers(1, min(9, len(live)) + 1))
            pick = rng.choice(len(live), size=m, replace=False)
            dels = np.asarray([live[i] for i in pick], np.int64)
            assert port.delete(dels) == ref.delete(dels)
            gone = set(dels.tolist())
            live = [g for g in live if g not in gone]
        if step % 6 == 5:
            port.flush()
            ref.flush()
        if step == 5:
            assert port.checkpoint() and ref.checkpoint()
    add(13)
    assert all(sub.delta.n_live > 0 for sub in port.shards)
    q = rng.normal(size=(7, DIM)).astype(np.float32)
    out = {
        "q": q, "coords": coords, "live": live, "dirs": dirs,
        "n_assigned": len(coords),
        "answers": {"port": port.constrained_knn(q, K, R),
                    "reference": ref.constrained_knn(q, K, R)},
        "points": {"port": port.live_points(), "reference": ref.live_points()},
        "port_live_gids": port.live_gids(),
    }
    port.close()
    ref.close()
    yield out
    mp.undo()


def _hold_answers(a, b, q, coords):
    """ids equal; distances within `_close`; -1 slots at +inf in both."""
    np.testing.assert_array_equal(a.gids, b.gids)
    assert (a.gids >= 0).any() and not a.partial and not b.partial
    for i in range(len(q)):
        for j, g in enumerate(a.gids[i]):
            if g < 0:
                assert np.isinf(a.distances[i, j]) and np.isinf(b.distances[i, j])
                continue
            assert _close(float(a.distances[i, j]), float(b.distances[i, j]),
                          q[i].astype(np.float64), coords[int(g)])


def test_interleave_matches_reference(cross):
    _hold_answers(cross["answers"]["port"], cross["answers"]["reference"],
                  cross["q"], cross["coords"])
    (pp, gp), (pr, gr) = cross["points"]["port"], cross["points"]["reference"]
    np.testing.assert_array_equal(gp, gr)
    np.testing.assert_array_equal(pp, pr)
    np.testing.assert_array_equal(cross["port_live_gids"], np.sort(cross["live"]))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_wal_dir_recovers_in_the_other_package(cross, writer):
    """The other package reopens the writer's four WALs and checkpoints:
    the same live set under the same global ids, the same answers, and
    global gid assignment resuming after every id ever assigned."""
    wal_dir = cross["dirs"][writer]
    assert {f"shard{s:03d}.wal" for s in range(4)} <= set(os.listdir(wal_dir))
    dst = (ShardedStreamingIndex(_cfg(), n_shards=4, wal_dir=wal_dir)
           if writer == "reference" else
           JSharded(JConfig(dim=DIM, delta_capacity=48, merge_factor=3,
                            backend="host"), n_shards=4, wal_dir=wal_dir))
    pd, gd = dst.live_points()
    pw, gw = cross["points"][writer]
    np.testing.assert_array_equal(gd, gw)
    np.testing.assert_array_equal(pd, pw)
    _hold_answers(dst.constrained_knn(cross["q"], K, R),
                  cross["answers"][writer], cross["q"], cross["coords"])
    assert dst.add(np.zeros((1, DIM), np.float32))[0] == cross["n_assigned"]
    dst.close()


# -- the reference's identities, inside the port ------------------------------
def _interleave(sh, ref, rng, steps, on_step=None):
    live = []
    for step in range(steps):
        op = int(rng.integers(0, 4))
        if op <= 1 or not live:
            n = int(rng.integers(1, 40)) | 1
            pts = rng.normal(size=(n, DIM)).astype(np.float32)
            g1, g2 = sh.add(pts), ref.add(pts)
            np.testing.assert_array_equal(g1, g2)
            live.extend(g1.tolist())
        elif op == 2:
            m = int(rng.integers(1, min(9, len(live)) + 1))
            pick = rng.choice(len(live), size=m, replace=False)
            dels = np.asarray([live[i] for i in pick], np.int64)
            assert sh.delete(dels) == ref.delete(dels)
            gone = set(dels.tolist())
            live = [g for g in live if g not in gone]
        if on_step is not None:
            on_step(step)
    return live


def _check_flushed(sh, ref, rng, tag, r=R):
    sh.flush()
    ref.flush()
    q = rng.normal(size=(7, DIM)).astype(np.float32)
    _same(sh.constrained_knn(q, K, r), ref.constrained_knn(q, K, r), tag)


def test_sharded_equals_single_device_bitwise():
    """After every flush barrier the 4-shard index answers bitwise as the
    single-device one fed the same ops; between barriers (deltas
    non-empty) the result sets agree, distances to rtol 1e-6."""
    sh = ShardedStreamingIndex(_cfg(), n_shards=4)
    ref = StreamingIndex(_cfg())
    rng = np.random.default_rng(5)

    def on_step(step):
        if step % 5 == 2:
            q = rng.normal(size=(5, DIM)).astype(np.float32)
            a, b = sh.constrained_knn(q, K, R), ref.constrained_knn(q, K, R)
            for i in range(len(q)):
                assert set(a.gids[i].tolist()) == set(b.gids[i].tolist())
            np.testing.assert_allclose(a.distances, b.distances, rtol=1e-6, atol=0)
        if step % 6 == 5:
            _check_flushed(sh, ref, rng, f"step{step}")

    _interleave(sh, ref, rng, 18, on_step)
    _check_flushed(sh, ref, rng, "final")
    st = sh.stats()
    assert st["n_shards"] == 4 and sum(st["n_live_per_shard"]) == ref.n_live
    assert all(p["seals"] >= 3 for p in st["shards"])
    pa, ga = sh.live_points()
    pb, gb = ref.live_points()
    np.testing.assert_array_equal(ga, gb)
    np.testing.assert_array_equal(pa, pb)


def test_fully_tombstoned_shard():
    """Every gid with g % 4 == 2 dies: that shard's snapshot
    short-circuits on the host, the fold still returns the exact global
    answer, bitwise the single-device one."""
    sh = ShardedStreamingIndex(_cfg(), n_shards=4)
    ref = StreamingIndex(_cfg())
    rng = np.random.default_rng(6)
    live = _interleave(sh, ref, rng, 8)
    dead = np.asarray([g for g in live if g % 4 == 2], np.int64)
    assert len(dead)
    assert sh.delete(dead) == ref.delete(dead) == len(dead)
    assert sh.shards[2].n_live == 0
    _check_flushed(sh, ref, rng, "shard2-tombstoned")
    res = sh.knn(rng.normal(size=(3, DIM)).astype(np.float32), K)
    assert not np.any(res.gids % 4 == 2)


def test_kill_and_recover_from_wals(tmp_path):
    """Close the sharded index and reopen it from its four WALs alone:
    answers bitwise equal, epochs never move backward, and the
    recovered index still matches the single-device one."""
    wal_dir = str(tmp_path / "wals")
    sh = ShardedStreamingIndex(_cfg(), n_shards=4, wal_dir=wal_dir)
    ref = StreamingIndex(_cfg())
    rng = np.random.default_rng(7)
    live = _interleave(sh, ref, rng, 12)
    _check_flushed(sh, ref, rng, "pre-close")
    _interleave(sh, ref, rng, 3)
    pre_epochs = [s.log.epoch for s in sh.shards]
    q = rng.normal(size=(9, DIM)).astype(np.float32)
    before = sh.constrained_knn(q, K, 3.0)
    n_before = sh.n_live
    sh.close()
    sh2 = ShardedStreamingIndex(_cfg(), n_shards=4, wal_dir=wal_dir)
    assert sh2.n_live == n_before == ref.n_live and len(live) > 0
    _same(sh2.constrained_knn(q, K, 3.0), before, "recovered")
    for sub, e in zip(sh2.shards, pre_epochs):
        assert sub.log.epoch >= e, "epoch moved backward on recovery"
        assert sub.stats()["wal_replayed"] > 0
    _check_flushed(sh2, ref, rng, "post-recovery")
    sh2.close()


def test_crash_at_every_checkpoint_step_4shard(tmp_path):
    """One InjectedCrash at every checkpoint write step of a 4-shard
    checkpoint; recovery from the files alone equals the pre-crash index
    each time. A clean checkpoint then truncates every shard's log."""
    rng = np.random.default_rng(9)
    dim, k = 4, 3
    wal_dir = str(tmp_path / "sweep")
    cfg = StreamingConfig(dim=dim, delta_capacity=8, auto_checkpoint=False,
                          device="cpu")
    reopen = lambda: ShardedStreamingIndex(  # noqa: E731
        cfg, n_shards=4, wal_dir=wal_dir)
    sh = reopen()
    g = sh.add(rng.normal(size=(21, dim)))
    sh.delete(g[::4])
    sh.flush()
    q = rng.normal(size=(4, dim)).astype(np.float32)

    def state(s):
        p, gg = s.live_points()
        return p, gg, s.constrained_knn(q, k, 3.0)

    n = faults.count_steps(lambda: sh.checkpoint(), "checkpoint.step")
    assert n >= 4 * 10, f"4-shard sweep domain too small: {n}"
    for step in range(n):
        sh.add(rng.normal(size=(1, dim)))  # fresh state each round
        p0, g0, r0 = state(sh)
        with faults.active():
            faults.arm("checkpoint.step", after=step, times=1,
                       exc=faults.InjectedCrash)
            with pytest.raises(faults.InjectedCrash):
                sh.checkpoint()
        sh.close()
        sh = reopen()
        p1, g1, r1 = state(sh)
        np.testing.assert_array_equal(g0, g1, err_msg=f"step {step}")
        np.testing.assert_array_equal(p0, p1, err_msg=f"step {step}")
        _same(r0, r1, f"step {step}")
    assert sh.checkpoint()
    for s in range(4):
        path = os.path.join(wal_dir, f"shard{s:03d}.wal")
        assert len(list(wal_mod.replay(path))) == 0
    p0, g0, r0 = state(sh)
    sh.close()
    sh = reopen()
    p1, g1, r1 = state(sh)
    np.testing.assert_array_equal(g0, g1)
    _same(r0, r1, "checkpoints alone")
    sh.close()


# -- degraded-mode failover ---------------------------------------------------
@pytest.fixture(scope="module")
def sharded():
    rng = np.random.default_rng(13)
    idx = ShardedStreamingIndex(
        StreamingConfig(dim=4, delta_capacity=16, device="cpu"),
        n_shards=2,
        failover=FailoverPolicy(max_retries=1, backoff_s=0.001),
    )
    idx.add(rng.normal(size=(40, 4)))
    idx.flush()
    q = rng.normal(size=(5, 4)).astype(np.float32)
    return idx, q


def test_single_shard_failure_returns_flagged_partial(sharded):
    idx, q = sharded
    full = idx.constrained_knn(q, 4, 3.0)
    assert not full.partial
    before = obs.REGISTRY.counter("shard.failovers", shard=1).value
    partial_before = obs.REGISTRY.counter("shard.partial_queries").value
    with faults.active():
        faults.arm("shard.search", shard=1, exc=InjectedFault)
        res = idx.constrained_knn(q, 4, 3.0)
    assert res.partial, "skipped shard must flag the result partial"
    valid = res.gids[res.gids >= 0]
    assert len(valid), "surviving shard's answers must still flow"
    assert np.all(valid % 2 == 0), "only shard-0 (even) gids expected"
    assert obs.REGISTRY.counter("shard.failovers", shard=1).value == before + 1
    assert obs.REGISTRY.counter("shard.partial_queries").value == partial_before + 1
    # the partial answer is exactly the full answer restricted to the
    # surviving shard's points
    for i in range(len(q)):
        want = [g for g in full.gids[i].tolist() if g >= 0 and g % 2 == 0]
        got = [g for g in res.gids[i].tolist() if g >= 0]
        assert got[: len(want)] == want or set(want) <= set(got)


@pytest.mark.parametrize("fault", ["transient", "slow"])
def test_shard_fault_leaves_answer_whole(sharded, fault):
    """A transient fault heals via one retry (counted); a slow shard is
    not a failure. Either way the answer is the full one, bitwise."""
    idx, q = sharded
    full = idx.constrained_knn(q, 4, 3.0)
    before = obs.REGISTRY.counter("shard.search_retries", shard=0).value
    rule = ({"times": 1, "exc": InjectedFault} if fault == "transient"
            else {"sleep": 0.02})
    with faults.active():
        faults.arm("shard.search", shard=0, **rule)
        res = idx.constrained_knn(q, 4, 3.0)
    assert not res.partial
    _same(res, full)
    retries = obs.REGISTRY.counter("shard.search_retries", shard=0).value
    assert retries == before + (1 if fault == "transient" else 0)


def test_strict_mode_propagates_the_failure(sharded):
    idx, q = sharded
    old = idx.failover
    idx.failover = FailoverPolicy(enabled=False, max_retries=0)
    try:
        with faults.active():
            faults.arm("shard.search", shard=1, exc=InjectedFault)
            with pytest.raises(InjectedFault):
                idx.constrained_knn(q, 4, 3.0)
    finally:
        idx.failover = old


def test_all_shards_down_raises(sharded):
    idx, q = sharded
    with faults.active():
        faults.arm("shard.search", exc=InjectedFault)
        with pytest.raises(RuntimeError, match="all .* shards failed"):
            idx.constrained_knn(q, 4, 3.0)


# -- deferred merges + background compaction, plain and 4-shard ----------------
def _index(n_shards, **kw):
    cfg = StreamingConfig(device="cpu", **kw)
    if n_shards == 1:
        return StreamingIndex(cfg)
    return ShardedStreamingIndex(cfg, n_shards=n_shards)


def _stat(idx, key):
    st = idx.stats()
    return sum(p[key] for p in st["shards"]) if "shards" in st else st[key]


@pytest.mark.parametrize("n_shards", [1, 4])
def test_defer_merges_moves_compaction_off_write_path(n_shards):
    rng = np.random.default_rng(6)
    idx = _index(n_shards, dim=5, delta_capacity=8, defer_merges=True)
    idx.add(rng.normal(size=(200, 5)).astype(np.float32))
    assert _stat(idx, "tiered_merges") == 0  # the write path really deferred
    n_seg = _stat(idx, "n_segments")
    assert n_seg > 4 * n_shards
    q = rng.normal(size=(5, 5)).astype(np.float32)
    before = idx.knn(q, 4)
    while idx.maintain():
        pass
    assert _stat(idx, "tiered_merges") > 0
    assert _stat(idx, "n_segments") < n_seg
    assert _stat(idx, "maintenance_runs") > 0
    _same(idx.knn(q, 4), before)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_background_compaction_thread(n_shards):
    rng = np.random.default_rng(7)
    idx = _index(n_shards, dim=4, delta_capacity=8, defer_merges=True)
    idx.start_background_compaction(interval=0.01)
    try:
        for _ in range(10):
            idx.add(rng.normal(size=(20, 4)).astype(np.float32))
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if _stat(idx, "tiered_merges") > 0:
                break
            time.sleep(0.02)
        else:
            pytest.fail("background thread never merged")
    finally:
        idx.stop_background_compaction()
    # exactness survives concurrent background merging: same answers as
    # an index that received the identical stream without the thread
    idx2 = _index(n_shards, dim=4, delta_capacity=8, defer_merges=True)
    rng2 = np.random.default_rng(7)
    for _ in range(10):
        idx2.add(rng2.normal(size=(20, 4)).astype(np.float32))
    idx.flush()
    idx2.flush()
    while idx.maintain() or idx2.maintain():
        pass
    q = rng.normal(size=(6, 4)).astype(np.float32)
    _same(idx.knn(q, 5), idx2.knn(q, 5))


def test_no_card_raises():
    """No fallback hides the device: the sharded index asked for the
    card (the default) where there is none raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path cannot be shown")
    assert data_devices(1) is None
    with pytest.raises((RuntimeError, AssertionError)):
        ShardedStreamingIndex(StreamingConfig(dim=DIM), n_shards=4)
