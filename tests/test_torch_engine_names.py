"""The reference's public names in the port, with the reference's
contracts: `query/engine.observed_signatures`, `stack_stats` and the
`engine.signatures` gauge, `kernels/quantize.itemsize_of`,
`Snapshot.n_parts` and `DeltaBuffer.dim`; on the CPU. Modelled on the
reference's tests/test_query_engine.py (the signature bound, the
incremental stack refresh) and tests/test_obs.py (accounting under
threads)."""
import threading

import numpy as np
import pytest
import torch

from repro.core import TreeSpec as JTreeSpec
from repro.index import StreamingConfig as JConfig
from repro.index import StreamingIndex as JIndex
from repro.kernels import quantize as ref_quantize
from repro_torch import obs
from repro_torch.core import TreeSpec
from repro_torch.index import StreamingConfig, StreamingIndex
from repro_torch.kernels import quantize
from repro_torch.query import QuerySpec, engine

SPEC = TreeSpec.ballstar(leaf_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_index(dim, cap=64, factor=3):
    return StreamingIndex(StreamingConfig(dim=dim, delta_capacity=cap, spec=SPEC,
                                          merge_factor=factor, device="cpu"))


def test_signatures_are_recorded_and_bounded():
    """Each stacked dispatch records (class, pow2 member count, queries, k,
    dtype); across 30 writes with a fixed query batch the new signatures
    stay log-bounded, and the gauge holds the set's size."""
    sigs0 = engine.observed_signatures()
    assert isinstance(sigs0, frozenset)
    rng = np.random.default_rng(11)
    idx = make_index(2, cap=32, factor=2)
    queries = rng.standard_normal((4, 2))
    for op in range(30):
        if op % 5 == 4 and len(idx.live_gids()) > 20:
            idx.delete(rng.choice(idx.live_gids(), size=10, replace=False))
        else:
            idx.add(rng.standard_normal((int(rng.integers(8, 40)), 2)))
        idx.constrained_knn(queries, 5, 1.5)
    new = engine.observed_signatures() - sigs0
    assert 1 <= len(new) <= 12
    for cls, n_slots, n_queries, k, dtype in new:
        assert isinstance(cls, tuple) and n_slots & (n_slots - 1) == 0
        assert (n_queries, k, dtype) == (4, 5, str(torch.float32))
    if obs.REGISTRY.enabled:
        gauge = obs.REGISTRY.gauge("engine.signatures").value
        assert gauge == len(engine.observed_signatures())


def test_incremental_restack_counts():
    """A tombstone in one member of a 3-segment class patches that slot
    (one incremental update, no full build), and answers as before."""
    rng = np.random.default_rng(21)
    pts = rng.standard_normal((150, 2))
    idx = make_index(2, cap=64, factor=5)
    for _ in range(3):  # identical point sets -> one shape class, S=3
        idx.bulk_load(pts)
    assert len(engine.plan(idx.snapshot())) == 1
    queries = rng.standard_normal((5, 2))
    idx.constrained_knn(queries, 4, np.inf)
    s0 = engine.stack_stats()
    assert set(s0) == {"full_builds", "incremental_updates"}
    idx.delete(idx.segments[1].gids[:5])
    got = idx.constrained_knn(queries, 4, np.inf)
    s1 = engine.stack_stats()
    assert s1["incremental_updates"] == s0["incremental_updates"] + 1
    assert s1["full_builds"] == s0["full_builds"]
    assert not np.isin(np.asarray(got.gids), idx.segments[1].gids[:5]).any()


def test_signatures_under_threads():
    """Threads dispatching concurrently: every signature is kept (the set
    is guarded by its own lock) and the stack counters move."""
    rng = np.random.default_rng(2)
    idx = make_index(3)
    for s in range(2):
        idx.bulk_load(rng.standard_normal((40 + 30 * s, 3)))
    snap = idx.snapshot()
    errs = []

    def work(i):
        local = np.random.default_rng(100 + i)
        try:
            for _ in range(2):
                engine.execute(snap, local.standard_normal((i + 1, 3)),
                               QuerySpec(k=3, radius=np.inf))
        except Exception as e:  # pragma: no cover - failure reporting
            errs.append(e)

    ts = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    seen = {q for _, _, q, _, _ in engine.observed_signatures()}
    assert set(range(1, 5)) <= seen
    ss = engine.stack_stats()
    assert ss["full_builds"] + ss["incremental_updates"] >= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_itemsize_of_matches_reference(dtype):
    assert quantize.itemsize_of(dtype) == ref_quantize.itemsize_of(dtype)
    with pytest.raises(ValueError):
        quantize.itemsize_of("float16")


def test_n_parts_and_delta_dim_match_reference():
    rng = np.random.default_rng(5)
    port = make_index(3, cap=32)
    ref = JIndex(JConfig(dim=3, delta_capacity=32, merge_factor=3,
                         spec=JTreeSpec.ballstar(leaf_size=8), backend="host"))
    for op in (lambda i, p: i.bulk_load(p), lambda i, p: i.add(p[:10]),
               lambda i, p: i.add(p), lambda i, p: i.flush()):
        pts = rng.standard_normal((40, 3))
        for index in (port, ref):
            op(index, pts)
        assert port.snapshot().n_parts == ref.snapshot().n_parts
        assert port.delta.dim == ref.delta.dim == 3
