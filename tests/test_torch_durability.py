"""The port's durability tier (`index/{wal,checkpoint,faults}.py` wired into
`StreamingIndex`) held to the reference's own oracles, on device "cpu".

Analogues of the reference's single-device tests:

  * `tests/test_checkpoint_recovery.py` — checkpoint + WAL-tail recovery
    is bitwise equal to full replay; sequence numbers survive truncation;
    a crash injected at EVERY `checkpoint.step` ordinal recovers to the
    pre-crash state; torn and corrupt tails recover to the intact prefix;
    epoch and gid assignment resume;
  * `tests/test_fault_injection.py` — the injector's contract (its
    sharded-failover tests wait for the port of `index/sharded.py`);
  * `tests/test_sharded_streaming.py` — plain-index WAL replay and the
    torn tail.

Then the two packages read each other's files: a WAL + checkpoint
written by one recovers in the other to the same live gid set and the
same ids on 32 queries, distances within `_close` (rtol 1e-6, or the
expansion form's bound on the square for hits the delta arena scores,
as in `tests/test_torch_streaming.py`). Sizes are the reference's (dim
5, delta_capacity 16).
"""
import os

import numpy as np
import pytest
import torch

from repro.index import StreamingConfig as JConfig
from repro.index import StreamingIndex as JIndex
from repro.query import engine as jengine
from repro_torch import obs
from repro_torch.index import StreamingConfig, StreamingIndex, faults
from repro_torch.index import checkpoint as ckpt_mod
from repro_torch.index import wal as wal_mod
from repro_torch.index.faults import FaultInjector, InjectedFault


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mk(tmp, name, **kw):
    return StreamingConfig(
        dim=5,
        delta_capacity=16,
        wal_path=os.path.join(tmp, f"{name}.wal"),
        device="cpu",
        **kw,
    )


def _apply_stream(idx, rng, n_steps=14):
    """A randomized op stream (seeded by the caller's rng) touching every
    WAL-logged mutator."""
    live = []
    for _ in range(n_steps):
        op = int(rng.integers(0, 5))
        if op <= 1 or not live:
            pts = rng.normal(size=(int(rng.integers(1, 12)), 5))
            live.extend(idx.add(pts).tolist())
        elif op == 2:
            m = int(rng.integers(1, min(6, len(live)) + 1))
            pick = rng.choice(len(live), size=m, replace=False)
            dels = np.asarray([live[i] for i in pick], np.int64)
            idx.delete(dels)
            gone = set(dels.tolist())
            live = [g for g in live if g not in gone]
        elif op == 3:
            idx.flush()
        else:
            idx.compact()
    return live


def _same_index(a, b, q, k=4, r=3.0):
    pa, ga = a.live_points()
    pb, gb = b.live_points()
    np.testing.assert_array_equal(ga, gb)
    np.testing.assert_array_equal(pa, pb)
    ra = a.constrained_knn(q, k, r)
    rb = b.constrained_knn(q, k, r)
    np.testing.assert_array_equal(ra.gids, rb.gids)
    np.testing.assert_array_equal(ra.distances, rb.distances)


# -- checkpoint + WAL-tail recovery ------------------------------------------
def test_checkpoint_bounds_log_and_recovery_is_bit_identical(tmp_path):
    """Twin op streams — one checkpointing, one never — recover to the
    same index; the checkpointing one's log holds only the tail."""
    tmp = str(tmp_path)
    rng_a = np.random.default_rng(21)
    rng_b = np.random.default_rng(21)
    a = StreamingIndex(_mk(tmp, "a"))
    b = StreamingIndex(_mk(tmp, "b", auto_checkpoint=False))
    _apply_stream(a, rng_a)
    _apply_stream(b, rng_b)
    assert a.checkpoint()
    tail_a = a.add(rng_a.normal(size=(6, 5)))
    tail_b = b.add(rng_b.normal(size=(6, 5)))
    np.testing.assert_array_equal(tail_a, tail_b)
    a.delete(tail_a[:2])
    b.delete(tail_b[:2])

    n_a = len(list(wal_mod.replay(a.config.wal_path)))
    n_b = len(list(wal_mod.replay(b.config.wal_path)))
    assert 0 < n_a < n_b
    assert a.stats()["checkpoints"] >= 1

    q = np.random.default_rng(3).normal(size=(6, 5)).astype(np.float32)
    _same_index(a, b, q)
    a.close()
    b.close()
    a2 = StreamingIndex(_mk(tmp, "a"))
    b2 = StreamingIndex(_mk(tmp, "b", auto_checkpoint=False))
    _same_index(a2, a, q)   # checkpoint + tail == pre-crash state
    _same_index(b2, b, q)   # full replay == pre-crash state
    _same_index(a2, b2, q)  # and the two recovery paths agree
    a2.close()
    b2.close()


def test_sequence_numbers_survive_truncation_and_reopen(tmp_path):
    cfg = _mk(str(tmp_path), "seq", auto_checkpoint=False)
    idx = StreamingIndex(cfg)
    idx.add(np.zeros((3, 5), np.float32))
    idx.add(np.ones((2, 5), np.float32))
    assert idx._wal.last_seq == 2
    assert idx.checkpoint()
    assert len(list(wal_mod.replay(cfg.wal_path))) == 0
    assert idx._wal.last_seq == 2
    idx.add(np.zeros((1, 5), np.float32))
    records = list(wal_mod.replay(cfg.wal_path))
    assert [wal_mod.record_seq(f, i + 1) for i, (_, f) in
            enumerate(records)] == [3]
    idx.close()
    idx2 = StreamingIndex(cfg)
    assert idx2._wal.last_seq == 3
    assert idx2.n_live == 6
    idx2.close()


def test_crash_at_every_checkpoint_step_single_device(tmp_path):
    """One InjectedCrash per checkpoint write step; after each crash,
    recovery from the files alone equals the pre-crash index. No step
    is skipped."""
    cfg = _mk(str(tmp_path), "sweep", auto_checkpoint=False)
    rng = np.random.default_rng(7)
    idx = StreamingIndex(cfg)
    _apply_stream(idx, rng, n_steps=10)
    q = rng.normal(size=(5, 5)).astype(np.float32)

    n = faults.count_steps(lambda: idx.checkpoint(), "checkpoint.step")
    assert n >= 10, f"sweep domain suspiciously small: {n} steps"
    for k in range(n):
        idx.add(rng.normal(size=(2, 5)))  # fresh state every round
        with faults.active():
            faults.arm(
                "checkpoint.step", after=k, times=1,
                exc=faults.InjectedCrash,
            )
            with pytest.raises(faults.InjectedCrash):
                idx.checkpoint()
        idx.close()
        recovered = StreamingIndex(cfg)
        _same_index(recovered, idx, q)
        idx = recovered
    idx.close()


def test_torn_and_corrupt_tail_after_checkpoint(tmp_path):
    """Damage in the post-checkpoint tail: the intact prefix (checkpoint
    + clean tail records) survives, the garbage is dropped."""
    cfg = _mk(str(tmp_path), "tear", auto_checkpoint=False)
    idx = StreamingIndex(cfg)
    g = idx.add(np.random.default_rng(0).normal(size=(20, 5)))
    idx.flush()
    assert idx.checkpoint()
    idx.add(np.full((2, 5), 7.0, np.float32))   # tail record 1 (intact)
    idx.delete(g[:3])                           # tail record 2 (to tear)
    idx.close()

    faults.tear_last_frame(cfg.wal_path)
    r1 = StreamingIndex(cfg)
    assert r1.n_live == 22  # the tear dropped the delete
    r1.close()

    faults.corrupt_frame(cfg.wal_path, index=0)
    r2 = StreamingIndex(cfg)
    assert r2.n_live == 20  # the whole tail is garbage now
    r2.close()

    # a corrupt checkpoint over a truncated log: a clean empty recovery
    with open(ckpt_mod.default_path(cfg.wal_path), "r+b") as f:
        f.seek(20)
        f.write(b"\xff\xff\xff")
    r3 = StreamingIndex(cfg)
    assert r3.n_live == 0
    r3.close()


def test_epoch_and_gids_resume_after_checkpoint_recovery(tmp_path):
    cfg = _mk(str(tmp_path), "epoch")
    idx = StreamingIndex(cfg)
    g = idx.add(np.random.default_rng(1).normal(size=(40, 5)))
    idx.compact()            # bumps epoch; auto-checkpoints after
    idx.delete(g[:5])
    pre_epoch = idx.log.epoch
    pre_next = idx.log.next_gid
    assert pre_epoch >= 1
    idx.close()
    idx2 = StreamingIndex(cfg)
    assert idx2.log.epoch >= pre_epoch, "epoch moved backward"
    assert idx2.log.next_gid == pre_next
    g2 = idx2.add(np.zeros((1, 5), np.float32))
    assert g2[0] == pre_next, "gid assignment restarted"
    idx2.close()


def test_host_backend_recovers_and_jax_is_refused(tmp_path):
    """`backend="host"` builds seals and merges with the numpy builder
    (and recovery rebuilds with it too); the reference's "jax" has no
    builder here and is refused."""
    with pytest.raises(ValueError, match="backend"):
        StreamingConfig(dim=5, backend="jax", device="cpu")
    rng = np.random.default_rng(8)
    host = StreamingIndex(_mk(str(tmp_path), "host", backend="host"))
    dev = StreamingIndex(StreamingConfig(dim=5, delta_capacity=16, device="cpu"))
    for idx in (host, dev):
        g = idx.add(np.random.default_rng(9).normal(size=(70, 5)))
        idx.delete(g[::5])
    q = rng.normal(size=(8, 5)).astype(np.float32)
    a, b = host.constrained_knn(q, 4, 3.0), dev.constrained_knn(q, 4, 3.0)
    np.testing.assert_array_equal(a.gids, b.gids)
    np.testing.assert_allclose(a.distances, b.distances, rtol=1e-6)
    host.close()
    rec = StreamingIndex(host.config)
    assert rec.stats()["wal_replayed"] == 2
    _same_index(rec, host, q)
    rec.close()


# -- plain-index WAL replay --------------------------------------------------
def test_wal_replay_rebuilds_plain_index(tmp_path):
    rng = np.random.default_rng(2)
    dim, k = 5, 4
    cfg = StreamingConfig(dim=dim, delta_capacity=32,
                          wal_path=str(tmp_path / "idx.wal"), device="cpu")
    idx = StreamingIndex(cfg)
    g = idx.add(rng.normal(size=(100, dim)).astype(np.float32))
    idx.delete(g[::7])
    idx.flush()
    q = rng.normal(size=(6, dim)).astype(np.float32)
    before = idx.constrained_knn(q, k, 2.0)
    epoch_before = idx.log.epoch
    pts_b, gids_b = idx.live_points()
    idx.close()

    rec = StreamingIndex(cfg)  # same config: construction IS recovery
    after = rec.constrained_knn(q, k, 2.0)
    np.testing.assert_array_equal(before.gids, after.gids)
    np.testing.assert_array_equal(before.distances, after.distances)
    pts_a, gids_a = rec.live_points()
    np.testing.assert_array_equal(gids_b, gids_a)
    np.testing.assert_array_equal(pts_b, pts_a)
    assert rec.log.epoch >= epoch_before
    g2 = rec.add(rng.normal(size=(3, dim)).astype(np.float32))
    assert g2[0] == 100  # gid assignment resumes
    rec.close()


def test_wal_torn_tail_recovers_valid_prefix(tmp_path):
    rng = np.random.default_rng(4)
    dim = 4
    cfg = StreamingConfig(dim=dim, delta_capacity=16,
                          wal_path=str(tmp_path / "torn.wal"), device="cpu")
    idx = StreamingIndex(cfg)
    idx.add(rng.normal(size=(40, dim)).astype(np.float32))
    n_live = idx.n_live
    idx.close()
    with open(cfg.wal_path, "ab") as f:  # a crash mid-append
        f.write(b"\x37\x13" * 9)
    rec = StreamingIndex(cfg)
    assert rec.n_live == n_live
    rec.add(rng.normal(size=(5, dim)).astype(np.float32))
    rec.close()
    records = list(wal_mod.replay(cfg.wal_path))
    assert [op for op, _ in records] == ["add", "add"]
    rec2 = StreamingIndex(cfg)
    assert rec2.n_live == n_live + 5
    rec2.close()


# -- the injector itself -----------------------------------------------------
def test_rules_are_ordinal_deterministic():
    inj = FaultInjector()
    inj.arm("x", after=2, times=2, exc=InjectedFault)
    fired = []
    for _ in range(8):
        try:
            inj.fire("x")
            fired.append(False)
        except InjectedFault:
            fired.append(True)
    assert fired == [False, False, True, True, False, False, False, False]
    assert inj.hits("x") == 8


def test_label_matching_and_hit_counting():
    inj = FaultInjector()
    inj.arm("shard.search", shard=1, exc=InjectedFault)
    inj.fire("shard.search", shard=0)  # no match
    with pytest.raises(InjectedFault):
        inj.fire("shard.search", shard=1)
    assert inj.hits("shard.search") == 2


def test_probabilistic_rules_replay_identically():
    def run():
        inj = FaultInjector()
        inj.arm("y", p=0.5, seed=42, exc=InjectedFault)
        out = []
        for _ in range(32):
            try:
                inj.fire("y")
                out.append(0)
            except InjectedFault:
                out.append(1)
        return out

    a, b = run(), run()
    assert a == b, "same seed must replay the same fault schedule"
    assert 0 < sum(a) < 32


def test_active_scope_resets_and_disarm():
    with faults.active():
        rule = faults.arm("z", exc=InjectedFault)
        with pytest.raises(InjectedFault):
            faults.fire("z")
        faults.disarm(rule)
        faults.fire("z")  # disarmed: no raise
    faults.fire("z")  # out of scope: injector is clean
    assert not faults.INJECTOR.enabled


def test_count_steps_counts_without_firing():
    def fn():
        for _ in range(5):
            faults.fire("steps")

    assert faults.count_steps(fn, "steps") == 5
    assert not faults.INJECTOR.enabled


def test_injected_faults_are_counted_on_obs():
    before = obs.REGISTRY.counter("faults.injected", site="w").value
    with faults.active():
        faults.arm("w", exc=InjectedFault, times=3)
        for _ in range(5):
            try:
                faults.fire("w")
            except InjectedFault:
                pass
    assert obs.REGISTRY.counter(
        "faults.injected", site="w"
    ).value == before + 3


# -- the two packages read each other's files --------------------------------
def _close(dp, dj, q, p):
    """rtol 1e-6, or within the expansion-form bound on the square."""
    if abs(dp - dj) <= 1e-6 * dj:
        return True
    bound = 8 * 2.0**-24 * (float(q @ q) + float(p @ p))
    return abs(dp * dp - dj * dj) <= bound


def _write_history(idx, rng):
    """An op stream with a checkpoint in the middle: recovery reads the
    checkpoint and then a WAL tail with adds, deletes and a flush."""
    _apply_stream(idx, rng, n_steps=10)
    assert idx.checkpoint()
    g = idx.add(rng.normal(size=(13, 5)))
    idx.delete(g[::3])
    idx.flush()
    idx.add(rng.normal(size=(5, 5)))


def _reference_classic_loop(monkeypatch):
    """Answer on the reference's side through its classic in-loop
    traversal, which its own tests hold bitwise equal to its fused one
    (`tests/test_fused_traversal.py`), at about half the fused path's
    first JAX compile."""
    monkeypatch.setattr(jengine, "_fused_enabled", lambda: False)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_files_recover_in_the_other_package(tmp_path, writer, monkeypatch):
    _reference_classic_loop(monkeypatch)
    wal_path = str(tmp_path / f"{writer}.wal")
    ref_cfg = JConfig(dim=5, delta_capacity=16, backend="host",
                      wal_path=wal_path)
    port_cfg = StreamingConfig(dim=5, delta_capacity=16, device="cpu",
                               wal_path=wal_path)
    make_writer, make_reader = (
        (lambda: JIndex(ref_cfg), lambda: StreamingIndex(port_cfg))
        if writer == "reference"
        else (lambda: StreamingIndex(port_cfg), lambda: JIndex(ref_cfg))
    )
    src = make_writer()
    _write_history(src, np.random.default_rng(31))
    q = np.random.default_rng(32).normal(size=(32, 5)).astype(np.float32)
    want = src.constrained_knn(q, 4, 2.5)
    pw, gw = src.live_points()
    src.close()

    dst = make_reader()
    assert dst.stats()["checkpoints"] == 0  # read, not written
    got = dst.constrained_knn(q, 4, 2.5)
    pd, gd = dst.live_points()
    np.testing.assert_array_equal(gd, gw)
    np.testing.assert_array_equal(pd, pw)
    np.testing.assert_array_equal(got.gids, want.gids)
    assert (got.gids >= 0).any()
    pos = {int(g): i for i, g in enumerate(gd)}
    for i in range(len(q)):
        for j, g in enumerate(got.gids[i]):
            if g < 0:
                assert np.isinf(got.distances[i, j]) and np.isinf(want.distances[i, j])
                continue
            p = pd[pos[int(g)]].astype(np.float64)
            assert _close(float(got.distances[i, j]), float(want.distances[i, j]),
                          q[i].astype(np.float64), p)
    dst.close()
