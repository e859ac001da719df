"""The port's serving tier (`serve/frontend.py`, `serve/retrieval.py`) held
to the reference's own oracles, on device "cpu".

Analogues of:

  * `tests/test_admission_control.py` — overload policies, deadlines,
    retries, shutdown hygiene and warmup against a host-only fake index
    (queue dynamics, not search time, are under test; the
    ``frontend.dispatch`` fault site makes them reproducible), plus the
    full stack over a small port index;
  * the first three tests of `tests/test_serve_frontend.py` —
    concurrent clients get bitwise the direct search's answer, every
    dispatch lies in the pow2 class set, stop() drains;
  * the Datastore tests of `tests/test_streaming_index.py`,
    `tests/test_quantized.py` and `tests/test_query_engine.py`.

And the port's Datastore against the reference's on the same pairs and
the same add/delete history: the same token values and valid masks,
distances within rtol 1e-6 or the expansion form's bound on the square
(delta-arena hits; see `tests/test_torch_streaming.py`).
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.query import QuerySpec as JQuerySpec
from repro.query import engine as jengine
from repro.serve.retrieval import Datastore as JDatastore
from repro_torch import obs
from repro_torch.core import TreeSpec
from repro_torch.index import StreamingConfig, StreamingIndex, faults
from repro_torch.index.search import StreamResult
from repro_torch.query import QuerySpec
from repro_torch.serve.frontend import (
    DeadlineExceededError,
    FrontendConfig,
    FrontendStopped,
    OverloadError,
    RetryingClient,
    RetryPolicy,
    SearchFrontend,
    next_pow2,
)
from repro_torch.serve.retrieval import Datastore, knn_interpolate


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class FakeIndex:
    """Streaming-search surface with no device work."""

    dim = 4

    def __init__(self, partial: bool = False) -> None:
        self.partial = partial

    def constrained_knn(self, q, k, r):
        n = len(q)
        return StreamResult(
            gids=np.zeros((n, k), np.int64),
            distances=np.zeros((n, k), np.float32),
            partial=self.partial,
        )


def _frontend(**cfg_kw):
    cfg = FrontendConfig(k=2, warmup=False, **cfg_kw)
    return SearchFrontend(FakeIndex(), cfg)


# -- admission control (fake index) ------------------------------------------
def test_overload_policy_validation():
    with pytest.raises(ValueError):
        FrontendConfig(overload_policy="drop_everything")
    with pytest.raises(ValueError):
        FrontendConfig(max_batch=12)


def test_reject_policy_raises_and_counts():
    fe = _frontend(max_batch=2, max_queue=2, overload_policy="reject")
    fe.start()
    before = obs.REGISTRY.counter("serve.admission.rejected").value
    with faults.active():
        faults.arm("frontend.dispatch", sleep=0.1)
        futs, rejected = [], 0
        for _ in range(30):
            try:
                futs.append(fe.submit(np.zeros(4)))
            except OverloadError:
                rejected += 1
        assert rejected > 0
        for f in futs:
            assert f.result(10).gids.shape == (2,)
    fe.stop()
    assert obs.REGISTRY.counter(
        "serve.admission.rejected"
    ).value == before + rejected


def test_shed_oldest_policy_fails_oldest_not_newest():
    fe = _frontend(max_batch=2, max_queue=2, overload_policy="shed_oldest")
    fe.start()
    before = obs.REGISTRY.counter("serve.admission.shed").value
    with faults.active():
        faults.arm("frontend.dispatch", sleep=0.1)
        futs = [fe.submit(np.zeros(4)) for _ in range(30)]
        outcomes = []
        for f in futs:
            try:
                f.result(10)
                outcomes.append("ok")
            except OverloadError:
                outcomes.append("shed")
    fe.stop()
    shed = outcomes.count("shed")
    assert shed > 0
    assert outcomes[-1] == "ok"  # freshest wins
    assert obs.REGISTRY.counter(
        "serve.admission.shed"
    ).value == before + shed


def test_deadlines_expire_before_dispatch():
    fe = _frontend(max_batch=2, default_deadline_s=0.03)
    fe.start()
    before = obs.REGISTRY.counter("serve.admission.deadline_expired").value
    with faults.active():
        faults.arm("frontend.dispatch", sleep=0.15)
        futs = [fe.submit(np.zeros(4)) for _ in range(8)]
        safe = fe.submit(np.zeros(4), deadline_s=30.0)
        expired = sum(
            1 for f in futs
            if isinstance(f.exception(10), DeadlineExceededError)
        )
        assert expired > 0
        assert safe.result(10).gids.shape == (2,)
    fe.stop()
    assert obs.REGISTRY.counter(
        "serve.admission.deadline_expired"
    ).value == before + expired


def test_retrying_client_clears_transient_faults():
    fe = _frontend(max_batch=1)
    fe.start()
    before = obs.REGISTRY.counter("serve.client.retries").value
    client = RetryingClient(
        fe, RetryPolicy(max_attempts=5, base_backoff_s=0.005)
    )
    with faults.active():
        faults.arm("frontend.dispatch", times=2, exc=faults.InjectedFault)
        reply = client.search(np.zeros(4), timeout=10)
    assert reply.gids.shape == (2,)
    assert obs.REGISTRY.counter(
        "serve.client.retries"
    ).value == before + 2
    fe.stop()


def test_retrying_client_gives_up_on_nonretryable():
    fe = _frontend(max_batch=1, default_deadline_s=0.01)
    fe.start()
    client = RetryingClient(fe, RetryPolicy(max_attempts=5))
    with faults.active():
        faults.arm("frontend.dispatch", sleep=0.1)
        blocker = fe.submit(np.zeros(4), deadline_s=30.0)
        with pytest.raises(DeadlineExceededError):
            client.search(np.zeros(4), timeout=10)
        blocker.result(10)
    fe.stop()


def test_submit_after_stop_raises_immediately():
    fe = _frontend(max_batch=1)
    fe.start()
    fe.submit(np.zeros(4)).result(10)
    fe.stop()
    t0 = time.perf_counter()
    with pytest.raises(FrontendStopped):
        fe.submit(np.zeros(4))
    assert time.perf_counter() - t0 < 0.5, "must fail fast, not block"


def test_stop_fails_rather_than_orphans_past_drain_deadline():
    fe = _frontend(max_batch=1, drain_timeout_s=0.2)
    fe.start()
    with faults.active():
        faults.arm("frontend.dispatch", sleep=0.5)
        futs = [fe.submit(np.zeros(4)) for _ in range(6)]
        fe.stop()
    served = sum(1 for f in futs if f.exception(0) is None)
    stopped = sum(
        1 for f in futs if isinstance(f.exception(0), FrontendStopped)
    )
    assert served + stopped == len(futs)
    assert stopped > 0, "drain deadline must have cut some futures"


def test_blocked_submitter_is_released_by_stop():
    fe = _frontend(max_batch=1, max_queue=1, overload_policy="block")
    fe.start()
    errs = []

    def submitter():
        try:
            for _ in range(50):
                fe.submit(np.zeros(4))
        except FrontendStopped:
            errs.append("stopped")

    with faults.active():
        faults.arm("frontend.dispatch", sleep=0.05)
        t = threading.Thread(target=submitter)
        t.start()
        time.sleep(0.1)  # let it wedge against the full queue
        fe.stop()
        t.join(5)
    assert not t.is_alive(), "blocked submit() must be woken by stop()"
    assert errs == ["stopped"]


def test_partial_flag_propagates_to_replies():
    fe = SearchFrontend(
        FakeIndex(partial=True), FrontendConfig(k=2, warmup=False)
    )
    fe.start()
    assert fe.submit(np.zeros(4)).result(10).partial
    fe.stop()


def test_warmup_covers_all_classes_and_times_itself():
    calls = []

    class Recorder(FakeIndex):
        def constrained_knn(self, q, k, r):
            calls.append(len(q))
            return super().constrained_knn(q, k, r)

    fe = SearchFrontend(Recorder(), FrontendConfig(k=2, max_batch=16))
    before = obs.REGISTRY.counter("serve.frontend.warmup_dispatches").value
    fe.start()
    fe.stop()
    # one dispatch per class, one after another, in order
    assert calls == [1, 2, 4, 8, 16]
    assert obs.REGISTRY.counter(
        "serve.frontend.warmup_dispatches"
    ).value == before + 5
    g = obs.REGISTRY.find("serve.frontend.warmup_seconds")
    assert g is not None and g.value > 0


def test_parallel_warmup_is_refused():
    # the reference's concurrent warm-up has nothing to overlap in the
    # port; the option stays for API parity and refuses True
    with pytest.raises(ValueError, match="warmup_parallel"):
        FrontendConfig(k=2, max_batch=16, warmup_parallel=True)
    assert FrontendConfig().warmup_parallel is False


def test_full_stack_over_real_index():
    rng = np.random.default_rng(17)
    idx = StreamingIndex(StreamingConfig(dim=4, delta_capacity=32, device="cpu"))
    idx.add(rng.normal(size=(50, 4)))
    fe = SearchFrontend(
        idx,
        FrontendConfig(
            k=3, max_batch=4, overload_policy="reject",
            default_deadline_s=30.0, warmup=True,
        ),
    )
    with fe:
        client = RetryingClient(fe)
        reply = client.search(
            rng.normal(size=4).astype(np.float32), timeout=60
        )
    assert reply.gids.shape == (3,)
    assert np.all(reply.gids >= 0)
    assert not reply.partial


# -- the frontend over a real port index --------------------------------------
@pytest.fixture(scope="module")
def served_index():
    rng = np.random.default_rng(3)
    idx = StreamingIndex(StreamingConfig(dim=8, delta_capacity=128, device="cpu"))
    idx.add(rng.normal(size=(600, 8)).astype(np.float32))
    idx.flush()
    return idx


def test_concurrent_clients_match_direct_search(served_index):
    """Answers do not depend on the batch a request lands in: every
    reply equals the direct search of all queries at once, bitwise."""
    rng = np.random.default_rng(8)
    cfg = FrontendConfig(k=5, radius=2.5, max_batch=16)
    fe = SearchFrontend(served_index, cfg)
    vecs = rng.normal(size=(80, 8)).astype(np.float32)
    results = [None] * len(vecs)
    with fe:
        def client(lo, hi):
            futs = [(i, fe.submit(vecs[i])) for i in range(lo, hi)]
            for i, f in futs:
                results[i] = f.result(60)

        threads = [
            threading.Thread(target=client, args=(j * 20, (j + 1) * 20))
            for j in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    direct = served_index.constrained_knn(vecs, 5, 2.5)
    for i, reply in enumerate(results):
        np.testing.assert_array_equal(reply.gids, direct.gids[i])
        np.testing.assert_array_equal(reply.distances, direct.distances[i])


def test_dispatches_bounded_by_batch_classes(served_index):
    cfg = FrontendConfig(k=4, max_batch=16)
    fe = SearchFrontend(served_index, cfg)
    base = {b: fe._c_dispatch[b].value for b in cfg.batch_classes}
    warm0 = fe._c_warmup.value
    rng = np.random.default_rng(9)
    with fe:
        futs = [
            fe.submit(rng.normal(size=8).astype(np.float32))
            for _ in range(50)
        ]
        for f in futs:
            f.result(60)
    per_class = {
        b: fe._c_dispatch[b].value - base[b] for b in cfg.batch_classes
    }
    assert sum(per_class.values()) > 0
    assert set(per_class) == set(cfg.batch_classes)
    assert all(b == next_pow2(b) for b in per_class)
    assert fe._c_warmup.value - warm0 == len(cfg.batch_classes)
    for b in cfg.batch_classes:
        assert (
            obs.REGISTRY.find("serve.frontend.dispatches", qclass=str(b))
            is fe._c_dispatch[b]
        )


def test_stop_drains_pending_requests(served_index):
    fe = SearchFrontend(
        served_index, FrontendConfig(k=3, max_batch=8, warmup=False)
    )
    fe.start()
    rng = np.random.default_rng(10)
    futs = [
        fe.submit(rng.normal(size=8).astype(np.float32)) for _ in range(20)
    ]
    fe.stop()
    for f in futs:
        assert f.result(1).gids.shape == (3,)
    with pytest.raises(RuntimeError):
        fe.submit(np.zeros(8, np.float32))


# -- Datastore ---------------------------------------------------------------
def test_datastore_add_delete_lookup():
    rng = np.random.default_rng(5)
    keys = rng.standard_normal((200, 4)).astype(np.float32)
    vals = rng.integers(0, 50, 200)
    store = Datastore.from_pairs(keys, vals, leaf_size=16, delta_capacity=64,
                                 device="cpu")
    assert store.n_keys == 200
    assert store.index.config.backend == "torch"

    new_keys = rng.standard_normal((30, 4)).astype(np.float32)
    new_vals = rng.integers(50, 99, 30)
    gids = store.add(new_keys, new_vals)
    assert store.n_keys == 230
    nv, nd, ok = store.lookup(new_keys[:1], k=1, r=1e-3)
    assert ok[0, 0] and nv[0, 0] == new_vals[0]

    store.delete(gids)
    assert store.n_keys == 200
    nv, nd, ok = store.lookup(new_keys[:1], k=1, r=1e-3)
    assert not ok.any()


def test_datastore_compaction_preserves_bindings():
    """Randomized insert/delete interleave (seals and tiered merges fire
    underneath): every live gid -> value binding survives, evicted gids'
    rows are recycled, and the arena reclaims after a remap epoch leaves
    it mostly holes."""
    rng = np.random.default_rng(17)
    keys0 = rng.normal(size=(200, 6)).astype(np.float32)
    vals0 = rng.integers(0, 99, 200).astype(np.int32)
    st = Datastore.from_pairs(keys0, vals0, leaf_size=8, delta_capacity=32,
                              device="cpu")
    ref = dict(zip(range(200), map(int, vals0)))

    for _ in range(40):
        if rng.random() < 0.55:
            m = int(rng.integers(1, 50))
            ks = rng.normal(size=(m, 6)).astype(np.float32)
            vs = rng.integers(0, 99, m).astype(np.int32)
            gs = st.add(ks, vs)
            ref.update(zip(map(int, gs), map(int, vs)))
        else:
            live = np.fromiter(ref.keys(), np.int64, len(ref))
            if not len(live):
                continue
            pick = rng.choice(
                live, size=min(len(live), int(rng.integers(1, 40))),
                replace=False,
            )
            st.delete(pick)
            for g in pick:
                ref.pop(int(g), None)
        assert st._row_of.keys() == set(ref.keys())
        for g, v in ref.items():
            assert int(st._values[st._row_of[g]]) == v

    live = np.fromiter(ref.keys(), np.int64, len(ref))
    rows_before = st.arena_rows
    reclaims = obs.REGISTRY.counter("serve.values_reclaims").value
    st.delete(live[: int(len(live) * 0.8)])
    for g in live[: int(len(live) * 0.8)]:
        ref.pop(int(g), None)
    st.index.compact()  # bumps the gid-remap epoch
    st.add(
        rng.normal(size=(1, 6)).astype(np.float32),
        rng.integers(0, 99, 1).astype(np.int32),
    )  # _maybe_reclaim runs on the next mutation
    assert obs.REGISTRY.counter("serve.values_reclaims").value > reclaims
    assert st._next_row < rows_before
    assert st._next_row == len(st._row_of)
    for g, v in list(ref.items()):
        assert int(st._values[st._row_of[g]]) == v

    q = rng.normal(size=(3, 6)).astype(np.float32)
    v_out, _, valid = st.lookup(q, k=2, r=np.inf)
    pts, gids = st.index.live_points()
    for i in range(3):
        if valid[i, 0]:
            j = int(np.argmin(np.sqrt(((pts - q[i]) ** 2).sum(1))))
            assert v_out[i, 0] == ref[int(gids[j])]


def test_datastore_search_adapter():
    rng = np.random.default_rng(13)
    keys = rng.standard_normal((80, 4)).astype(np.float32)
    vals = rng.integers(0, 9, 80)
    store = Datastore.from_pairs(keys, vals, leaf_size=16, delta_capacity=32,
                                 device="cpu")
    res = store.search(keys[:3], QuerySpec(k=1, radius=1e-3))
    assert (np.asarray(res.gids)[:, 0] == np.arange(3)).all()
    nv, nd, ok = store.lookup(keys[:3], k=1, r=1e-3)
    assert ok.all() and (nv[:, 0] == vals[:3]).all()
    out = knn_interpolate(np.full((3, 9), 1 / 9), nv, nd, ok, lam=0.5)
    np.testing.assert_allclose(out.sum(1), 1.0, rtol=1e-6)
    assert (out[np.arange(3), nv[:, 0]] > 0.5).all()


def _close(dp, dj, q, p):
    """rtol 1e-6, or within the expansion-form bound on the square."""
    if abs(dp - dj) <= 1e-6 * dj:
        return True
    bound = 8 * 2.0**-24 * (float(q @ q) + float(p @ p))
    return abs(dp * dp - dj * dj) <= bound


def _reference_classic_loop(monkeypatch):
    """Answer on the reference's side through its classic in-loop
    traversal, which its own tests hold bitwise equal to its fused one
    (`tests/test_fused_traversal.py`), at about half the fused path's
    first JAX compile."""
    monkeypatch.setattr(jengine, "_fused_enabled", lambda: False)


def test_datastore_lookups_match_reference(monkeypatch):
    """Same pairs, same add/delete history in both packages (one
    segment and the delta arena, both with tombstones): the same gids,
    token values and valid masks on 24 lookups; distances within
    `_close`."""
    _reference_classic_loop(monkeypatch)
    rng = np.random.default_rng(23)
    keys = rng.normal(size=(150, 3)).astype(np.float32)
    vals = rng.integers(0, 40, 150).astype(np.int32)
    spec = TreeSpec.ballstar(leaf_size=8)
    port = Datastore.from_pairs(keys, vals, spec=spec, delta_capacity=64,
                                device="cpu")
    ref = JDatastore.from_pairs(keys, vals, leaf_size=8, delta_capacity=64,
                                backend="host")
    for _ in range(3):
        ks = rng.normal(size=(20, 3)).astype(np.float32)
        vs = rng.integers(0, 40, 20).astype(np.int32)
        g = port.add(ks, vs)
        np.testing.assert_array_equal(g, ref.add(ks, vs))
        assert port.delete(g[::4]) == ref.delete(g[::4])
    q = rng.normal(size=(24, 3)).astype(np.float32)
    pv, pd, pok = port.lookup(q, k=4, r=1.0)
    jv, jd, jok = ref.lookup(q, k=4, r=1.0)
    np.testing.assert_array_equal(pok, jok)
    np.testing.assert_array_equal(pv, jv)
    assert pok.any() and not pok.all()
    pts, gids = port.index.live_points()
    pg = np.asarray(port.search(q, QuerySpec(k=4, radius=1.0)).gids)
    jg = np.asarray(ref.search(q, JQuerySpec(k=4, radius=1.0)).gids)
    np.testing.assert_array_equal(pg, jg)
    pos = {int(g): i for i, g in enumerate(gids)}
    for i in range(len(q)):
        for j in range(4):
            if pok[i, j]:
                p = pts[pos[int(pg[i, j])]].astype(np.float64)
                assert _close(float(pd[i, j]), float(jd[i, j]),
                              q[i].astype(np.float64), p)
