"""The port's spans and counters inside the write path, the serving
frontend and phase 1 of the search, held against the counters they
stand beside:

  * `index.add` / `index.delete` / `index.wal_append` / `index.seal` /
    `index.merge{kind}` spans count exactly what `index.wal_records`,
    `index.seals` and `index.merges{kind}` count, and record nothing with
    the registry off;
  * every frontier walk adds its loop iterations (a multiple of the
    check interval, one emptiness check per interval plus the last),
    lanes × iterations and the lanes' pops; the fused result is bitwise
    the same with the registry on and off;
  * the frontend's `serve.frontend.queue_wait` counts every dispatched
    request, `serve.frontend.respond` every dispatch, and the dispatcher's
    and responder's spans appear in a profile of all threads, on the
    main thread's timeline (and not in a default profile).
"""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs
from repro_torch.core import TreeSpec, build_host
from repro_torch.core import search as sj
from repro_torch.index import StreamingConfig, StreamingIndex
from repro_torch.kernels import quantize
from repro_torch.serve.frontend import FrontendConfig, SearchFrontend

SPEC = TreeSpec.ballstar(leaf_size=8)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def registry_on():
    """The process registry enabled for the test, as it was after."""
    was = obs.REGISTRY.enabled
    obs.REGISTRY.enable()
    yield obs.REGISTRY
    (obs.REGISTRY.enable if was else obs.REGISTRY.disable)()


def _span_count(name: str, **labels) -> int:
    h = obs.REGISTRY.find(f"span.{name}", **labels)
    return 0 if h is None else h.count


def _span_sum(name: str) -> float:
    h = obs.REGISTRY.find(f"span.{name}")
    return 0.0 if h is None else h.sum


WRITE_SPANS = (("index.add", {}), ("index.delete", {}), ("index.wal_append", {}),
               ("index.seal", {}), ("index.merge", {"kind": "tiered"}),
               ("index.merge", {"kind": "purge"}))


def _write_counts():
    return {(n, tuple(lb.items())): _span_count(n, **lb) for n, lb in WRITE_SPANS}


def _drive_writes(idx, rng):
    """Seals, a tiered merge, then a purge merge: 16-point adds into a
    16-slot delta seal every add; two sealed segments of one tier merge
    (merge_factor 2); deleting 20 of the merged 32 points leaves a
    segment more than half dead, rebuilt alone."""
    gids = [idx.add(rng.normal(size=(16, 2)).astype(np.float32)) for _ in range(2)]
    merged = np.concatenate(gids)
    idx.delete(merged[:10])
    idx.delete(merged[10:20])
    idx.add(rng.normal(size=(5, 2)).astype(np.float32))


def test_write_spans_equal_the_write_counters(tmp_path, registry_on):
    idx = StreamingIndex(StreamingConfig(
        dim=2, delta_capacity=16, merge_factor=2, device="cpu", backend="host",
        storage_dtype="float32", wal_path=str(tmp_path / "w.wal"),
        auto_checkpoint=False))
    before = _write_counts()
    sums = ("index.add", "index.delete", "index.wal_append", "index.seal")
    s0 = {n: _span_sum(n) for n in sums}
    _drive_writes(idx, np.random.default_rng(5))
    got = {key: v - before[key] for key, v in _write_counts().items()}
    secs = {n: _span_sum(n) - s0[n] for n in sums}
    st = idx.stats()
    idx.close()
    assert st["seals"] == 2 and st["tiered_merges"] == 1 and st["purge_merges"] == 1
    assert got[("index.add", ())] == 3 and got[("index.delete", ())] == 2
    assert got[("index.wal_append", ())] == st["wal_records"] == 5
    assert got[("index.seal", ())] == st["seals"]
    assert got[("index.merge", (("kind", "tiered"),))] == st["tiered_merges"]
    assert got[("index.merge", (("kind", "purge"),))] == st["purge_merges"]
    # nested: the mutators' spans hold their seals and records
    assert 0 < secs["index.wal_append"] + secs["index.seal"] <= (
        secs["index.add"] + secs["index.delete"])


def test_write_spans_record_nothing_with_the_registry_off(tmp_path):
    idx = StreamingIndex(StreamingConfig(
        dim=2, delta_capacity=16, merge_factor=2, device="cpu", backend="host",
        storage_dtype="float32", wal_path=str(tmp_path / "w.wal"),
        auto_checkpoint=False))
    was = obs.REGISTRY.enabled
    before = _write_counts()
    obs.REGISTRY.disable()
    try:
        _drive_writes(idx, np.random.default_rng(6))
    finally:
        (obs.REGISTRY.enable if was else obs.REGISTRY.disable)()
        idx.close()
    assert _write_counts() == before
    # the index itself is unchanged by the switch: 16 + 16 + 5 - 20 live
    assert idx.n_live == 17


# -- phase 1 --------------------------------------------------------------------
@pytest.fixture(scope="module")
def stacked():
    """Two same-shape trees of one point set stacked (S = 2), and 24
    queries."""
    rng = np.random.default_rng(21)
    pts = rng.standard_normal((400, 2)).astype(np.float32)
    tree = build_host.build(pts, SPEC)
    dt = sj.device_tree(tree, device="cpu")
    dts = sj.DeviceTree(*[torch.stack([x, x]) for x in dt])
    gids = torch.arange(tree.n_points, dtype=torch.int32)[None].repeat(2, 1)
    q = torch.from_numpy(rng.standard_normal((24, 2)).astype(np.float32))
    return dts, gids, q, sj.max_depth(tree) + 3


def _fused(stacked, k, r, sdt="float32"):
    dts, gids, q, ss = stacked
    lq = sc = None
    qerr = 0.0
    if sdt != "float32":
        lq, sc, qerr = quantize.quantize_leaves(dts.leaf_points[0], sdt)
        lq = torch.stack([lq, lq])
        sc = None if sc is None else torch.stack([sc, sc])
    return sj.constrained_knn_stacked_fused(dts, gids, q, r, k, ss, leaf_q=lq,
                                            qscale=sc, qerr=qerr)


def _phase1_counts():
    c = sj._C_PHASE1
    return (sj._C_SYNC["loop"].value, c["iters"].value, c["lane_iters"].value,
            c["visits"].value)


@pytest.mark.parametrize("k,r", [(1, 0.3), (6, 0.8), (10, np.inf)])
def test_phase1_iterations_lanes_and_visits(stacked, registry_on, k, r):
    s0, it0, li0, v0 = _phase1_counts()
    res = _fused(stacked, k, r)
    assert res is not None
    s1, it1, li1, v1 = _phase1_counts()
    iters, lane_iters, visits = it1 - it0, li1 - li0, v1 - v0
    lanes = 2 * stacked[2].shape[0]
    assert iters > 0 and iters % sj._SYNC_EVERY == 0
    assert s1 - s0 == iters // sj._SYNC_EVERY + 1   # one check per interval, and the last
    assert lane_iters == lanes * iters
    assert visits == int(res.nodes_visited.sum())
    assert 0 < visits <= lane_iters


def test_phase1_counters_silent_off_and_classic_uncounted(stacked):
    was = obs.REGISTRY.enabled
    before = _phase1_counts()[1:]
    obs.REGISTRY.disable()
    try:
        _fused(stacked, 6, 0.8)
    finally:
        (obs.REGISTRY.enable if was else obs.REGISTRY.disable)()
    assert _phase1_counts()[1:] == before
    obs.REGISTRY.enable()
    try:
        dts, gids, q, ss = stacked
        sj.constrained_knn_stacked(dts, gids, q, 0.8, 6, ss)   # the classic loop
        assert _phase1_counts()[1:] == before
    finally:
        (obs.REGISTRY.enable if was else obs.REGISTRY.disable)()


@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "int8"])
def test_fused_bitwise_with_registry_on_and_off(stacked, sdt):
    was = obs.REGISTRY.enabled
    try:
        obs.REGISTRY.enable()
        on = _fused(stacked, 6, 0.8, sdt)
        obs.REGISTRY.disable()
        off = _fused(stacked, 6, 0.8, sdt)
    finally:
        (obs.REGISTRY.enable if was else obs.REGISTRY.disable)()
    assert on is not None and off is not None
    for fld in on._fields:
        assert torch.equal(getattr(on, fld), getattr(off, fld)), fld


# -- the serving frontend ---------------------------------------------------------
@pytest.fixture(scope="module")
def served_index():
    rng = np.random.default_rng(3)
    idx = StreamingIndex(StreamingConfig(dim=4, delta_capacity=128, device="cpu"))
    idx.add(rng.normal(size=(500, 4)).astype(np.float32))
    idx.flush()
    return idx


def _dispatches(fe):
    return sum(c.value for c in fe._c_dispatch.values())


def test_frontend_queue_wait_and_respond_counts(served_index, registry_on):
    fe = SearchFrontend(served_index, FrontendConfig(k=3, radius=1.5, max_batch=8))
    rng = np.random.default_rng(4)
    names = ("serve.frontend.queue_wait", "serve.frontend.respond",
             "serve.frontend.dispatch")
    with fe:
        c0 = {n: _span_count(n) for n in names}
        w0, lat0 = _span_sum(names[0]), fe._h_latency.sum
        d0 = _dispatches(fe)
        futs = [fe.submit(rng.normal(size=4).astype(np.float32)) for _ in range(40)]
        for f in futs:
            f.result(60)
    got = {n: _span_count(n) - c0[n] for n in names}
    disp = _dispatches(fe) - d0
    assert got["serve.frontend.queue_wait"] == 40   # every request dispatched
    assert got["serve.frontend.respond"] == disp == got["serve.frontend.dispatch"]
    assert 0 < disp <= 40
    wait_s = _span_sum(names[0]) - w0
    assert 0 < wait_s <= (fe._h_latency.sum - lat0) / 1e3


def test_frontend_queue_wait_silent_off(served_index):
    was = obs.REGISTRY.enabled
    fe = SearchFrontend(served_index, FrontendConfig(k=3, max_batch=8, warmup=False))
    before = _span_count("serve.frontend.queue_wait")
    obs.REGISTRY.disable()
    try:
        with fe:
            for f in [fe.submit(np.zeros(4, np.float32)) for _ in range(5)]:
                f.result(60)
    finally:
        (obs.REGISTRY.enable if was else obs.REGISTRY.disable)()
    assert _span_count("serve.frontend.queue_wait") == before


FRONTEND_RANGES = ("serve.frontend.dispatch", "engine.dispatch", "serve.frontend.respond")
MAIN = "client.requests"


def _profile_requests(served_index, all_threads: bool):
    """A frontend started before the profiler; inside one main-thread
    range, 12 requests answered and the frontend stopped (its threads
    joined, so every range of theirs has closed)."""
    fe = SearchFrontend(served_index, FrontendConfig(k=3, max_batch=4)).start()
    kw = {}
    if all_threads:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    rng = np.random.default_rng(12)
    try:
        with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
            with record_function(MAIN):
                futs = [fe.submit(rng.normal(size=4).astype(np.float32))
                        for _ in range(12)]
                for f in futs:
                    f.result(60)
                fe.stop()
    finally:
        fe.stop()
    return [(ev.name(), ev.start_thread_id(), ev.start_ns(),
             ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.name() in FRONTEND_RANGES + (MAIN,)]


def test_frontend_ranges_in_a_profile_of_all_threads(served_index, registry_on):
    assert threading.current_thread() is threading.main_thread()
    evs = _profile_requests(served_index, all_threads=True)
    main = [e for e in evs if e[0] == MAIN]
    assert len(main) == 1
    _, main_tid, m0, m1 = main[0]
    tids = {}
    for name, tid, t0, t1 in evs:
        if name == MAIN:
            continue
        tids.setdefault(name, set()).add(tid)
        assert m0 <= t0 <= t1 <= m1, name   # one timeline, inside the main range
    assert set(tids) == set(FRONTEND_RANGES)
    # the dispatcher runs the engine; the responder is a thread of its own
    (disp,) = tids["serve.frontend.dispatch"]
    (resp,) = tids["serve.frontend.respond"]
    assert tids["engine.dispatch"] == {disp}
    assert len({main_tid, disp, resp}) == 3


def test_frontend_ranges_missing_from_a_default_profile(served_index, registry_on):
    """Why a profile of the main thread alone reads the serving cell's
    gaps as outside any range: the frontend's threads are not in it."""
    evs = _profile_requests(served_index, all_threads=False)
    assert [e[0] for e in evs] == [MAIN]
