"""The port's host layer (`core/{build_host,search_host,brute,pca}`, copies
of the reference's numpy modules on the port's own `core/types.py`) held
against the reference's, and the builder switch that reaches it.

  * `build_host` gives the reference's tree bitwise — every `Tree` field,
    same dtype, same values — for the ballstar, ball and kd specs;
  * every host search and brute oracle gives equal results and
    paper-metric counts (`SearchStats`, field by field);
  * `core.build(backend=...)` dispatches to the device builder ("torch",
    the default) or the host builder ("host");
  * a `StreamingIndex` (its seals and merges built by the device builder)
    answers like the port's brute oracle over the live set (equal gids;
    distances within rtol 1e-6, or, for hits the delta arena scores in
    the expansion form, within its cancellation bound
    8·2⁻²⁴·(|q|²+|p|²) on the square).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import TreeSpec as JTreeSpec
from repro.core import brute as jbrute
from repro.core import build_host as jbuild_host
from repro.core import pca as jpca
from repro.core import search_host as jsearch_host
from repro_torch import core
from repro_torch.core import TreeSpec, brute, build_host, search_host
from repro_torch.core.build import build as build_torch
from repro_torch.index import StreamingConfig, StreamingIndex

_FIELDS = ("center", "radius", "child_l", "child_r", "start", "count",
           "points", "perm", "leaf_of_node", "leaf_points", "leaf_index")
_SPECS = ("ballstar", "ball", "kd")
K, R = 5, 0.45


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _points(n=600, d=2, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("name", _SPECS)
@pytest.mark.parametrize("d", [2, 5])
def test_build_host_is_the_reference_tree_bitwise(name, d):
    pts = _points(d=d, seed=d)
    got = build_host.build(pts, getattr(TreeSpec, name)(leaf_size=8))
    want = jbuild_host.build(pts, getattr(JTreeSpec, name)(leaf_size=8))
    for f in _FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert dataclasses.asdict(got.spec) == dataclasses.asdict(want.spec)


_SEARCHES = {
    "constrained_knn": lambda m, t, q: m.constrained_knn(t, q, K, R),
    "constrained_knn_and": lambda m, t, q: m.constrained_knn(t, q, K, R, prune="and"),
    "knn_search": lambda m, t, q: m.knn_search(t, q, K),
    "range_search": lambda m, t, q: m.range_search(t, q, R),
    "knn_then_filter": lambda m, t, q: m.knn_then_filter(t, q, K, R),
}


@pytest.mark.parametrize("search", sorted(_SEARCHES))
def test_search_host_stats_equal_reference(search):
    pts = _points()
    tree = build_host.build(pts, TreeSpec.ballstar(leaf_size=8))
    jtree = jbuild_host.build(pts, JTreeSpec.ballstar(leaf_size=8))
    run = _SEARCHES[search]
    for q in np.random.default_rng(1).standard_normal((8, 2)):
        got, want = run(search_host, tree, q), run(jsearch_host, jtree, q)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert np.array_equal(a, b), (search, f.name)
        assert got.nodes_visited > 0
    assert search_host.leaf_frontier(tree, q, K, R) == jsearch_host.leaf_frontier(
        jtree, q, K, R
    )


def test_brute_and_pca_equal_reference():
    pts = _points(n=300, d=3).astype(np.float64)
    for q in np.random.default_rng(2).standard_normal((4, 3)):
        for fn, args in (("knn", (K,)), ("range_query", (0.8,)),
                         ("constrained_knn", (K, 0.8))):
            got = getattr(brute, fn)(pts, q, *args)
            want = getattr(jbrute, fn)(pts, q, *args)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b), fn
    x = pts @ np.diag([3.0, 1.0, 0.2])
    np.testing.assert_array_equal(
        core.first_component_host(x, iters=8, seed=4),
        jpca.first_component_host(x, iters=8, seed=4),
    )
    np.testing.assert_array_equal(
        core.first_component_exact(x), jpca.first_component_exact(x)
    )
    # a degenerate node keeps the start vector, as the reference does
    np.testing.assert_array_equal(
        core.first_component_host(np.ones((6, 3))),
        jpca.first_component_host(np.ones((6, 3))),
    )


def test_build_dispatch():
    pts = _points(n=300)
    spec = TreeSpec.ballstar(leaf_size=8)
    host = core.build(pts, spec, backend="host")
    dev = core.build(pts, spec, device="cpu")  # "torch" is the default
    ref_host = build_host.build(pts, spec)
    ref_dev = build_torch(pts, spec, device="cpu")
    for f in _FIELDS:
        assert np.array_equal(getattr(host, f), getattr(ref_host, f)), f
        assert np.array_equal(getattr(dev, f), getattr(ref_dev, f)), f
    assert host.points.dtype == np.float64 and dev.points.dtype == np.float32
    with pytest.raises(ValueError, match="backend"):
        core.build(pts, spec, backend="jax")


def test_streaming_device_builder_answers_like_brute():
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((700, 2)).astype(np.float32)
    queries = rng.standard_normal((9, 2)).astype(np.float32)
    ix = StreamingIndex(StreamingConfig(
        dim=2, delta_capacity=64, merge_factor=3,
        spec=TreeSpec.ballstar(leaf_size=8), device="cpu"))
    dead = np.arange(0, 700, 6)
    for lo in range(0, 700, 100):
        ix.add(pts[lo:lo + 100])
    ix.delete(dead)
    res = ix.constrained_knn(queries, K, R)
    assert ix.stats()["seals"] > 0
    live = np.setdiff1d(np.arange(700), dead)
    for i, q in enumerate(queries):
        bi, bd = brute.constrained_knn(pts[live].astype(np.float64), q, K, R)
        g = res.gids[i]
        assert np.array_equal(g[g >= 0], live[bi])
        # tree hits: rtol 1e-6; delta-arena hits are scored in the
        # expansion form: its cancellation bound on the square
        dp = res.distances[i][g >= 0].astype(np.float64)
        norms = float(q @ q) + (pts[live[bi]].astype(np.float64) ** 2).sum(1)
        ok = (np.abs(dp - bd) <= 1e-6 * bd) | (
            np.abs(dp * dp - bd * bd) <= 8 * 2.0**-24 * norms)
        assert ok.all()
