"""The port's traversal (`repro_torch.core.search`) on a reference-built
tree carried across (`repro_torch.convert`), held against
`repro.core.search_jax` on the same tree.

  * classic and fused, with f32, bf16 and int8 leaf storage: the same
    gids, the same paper-metric counts (nodes visited, leaves scanned,
    points examined — exactly), distances within rtol 1e-6 (both sum a
    2-term difference form in f32, rounding orders may differ);
  * inside the port, fused == classic BITWISE for every storage dtype,
    k and radius (one shared reduction order, no padding trick);
  * an overflowing frontier cap returns None from the fused call, and the
    engine falls back to the classic loop and counts it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import TreeSpec, build
from repro.core import search_jax as jsj
from repro.kernels import quantize as jquant
from repro_torch import convert, obs
from repro_torch.core import search as sj
from repro_torch.kernels import quantize
from repro_torch.query import QuerySpec
from repro_torch.query import engine

SPEC = TreeSpec.ballstar(leaf_size=8)
K, R = 6, 0.2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tree():
    rng = np.random.default_rng(11)
    pts = rng.standard_normal((500, 2)).astype(np.float32)
    return build(pts, SPEC, backend="jax")


@pytest.fixture(scope="module")
def queries():
    return np.random.default_rng(12).standard_normal((12, 2)).astype(np.float32)


def _jax_stacked(tree, queries, sdt, fused):
    dt = jsj.device_tree(tree)
    dts = jax.tree_util.tree_map(lambda x: x[None], dt)
    gids = jnp.arange(tree.n_points, dtype=jnp.int32)[None]
    q = jnp.asarray(queries)
    rb = jnp.full((q.shape[0],), R, jnp.float32)
    ss = jsj.max_depth(tree) + 3
    if not fused:
        return jsj.constrained_knn_stacked(dts, gids, q, rb, K, ss)
    lq, sc, qerr = jquant.quantize_leaves(np.asarray(dt.leaf_points), sdt)
    return jsj.constrained_knn_stacked_fused(
        dts, gids, q, rb, K, ss,
        leaf_q=None if lq is None else lq[None],
        qscale=None if sc is None else sc[None],
        qerr=qerr,
    )


def _port_stacked(tree, queries, sdt, fused, k=K, r=R, fcap=None):
    dt = convert.device_tree(tree, device="cpu")
    dts = sj.DeviceTree(*[x[None] for x in dt])
    gids = torch.arange(tree.n_points, dtype=torch.int32)[None]
    q = torch.from_numpy(queries)
    ss = sj.max_depth(convert.tree_from_reference(tree)) + 3
    if not fused:
        return sj.constrained_knn_stacked(dts, gids, q, r, k, ss)
    lq, sc, qerr = quantize.quantize_leaves(dt.leaf_points, sdt)
    return sj.constrained_knn_stacked_fused(
        dts, gids, q, r, k, ss, frontier_cap=fcap,
        leaf_q=None if lq is None else lq[None],
        qscale=None if sc is None else sc[None],
        qerr=qerr,
    )


@pytest.mark.parametrize(
    "sdt,fused",
    [("float32", False), ("float32", True), ("bfloat16", True), ("int8", True)],
)
def test_matches_reference_on_shared_tree(tree, queries, sdt, fused):
    ref = _jax_stacked(tree, queries, sdt, fused)
    got = _port_stacked(tree, queries, sdt, fused)
    assert got is not None and ref is not None
    assert np.array_equal(np.asarray(ref.gids), got.gids.numpy())
    for fld in ("nodes_visited", "leaves_visited", "points_examined"):
        assert np.array_equal(
            np.asarray(getattr(ref, fld)), getattr(got, fld).numpy()
        ), fld
    jd, td = np.asarray(ref.distances), got.distances.numpy()
    fin = np.isfinite(jd)
    assert np.array_equal(fin, np.isfinite(td))
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-6, atol=0)
    assert fin.any() and not fin.all()  # the radius gate is exercised


@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k,r", [(1, 0.3), (8, np.inf), (40, 0.9)])
def test_fused_bitwise_equals_classic(tree, queries, sdt, k, r):
    classic = _port_stacked(tree, queries, "float32", False, k=k, r=r)
    fused = _port_stacked(tree, queries, sdt, True, k=k, r=r)
    assert fused is not None
    for fld in classic._fields:
        assert torch.equal(getattr(classic, fld), getattr(fused, fld)), fld


def test_frontier_overflow_falls_back_and_is_counted(tree, queries, monkeypatch):
    assert _port_stacked(tree, queries, "float32", True, fcap=1) is None
    spec = QuerySpec(k=K, radius=R)
    want = sj.search(convert.tree_from_reference(tree), queries, K, R,
                     device="cpu")
    counter = obs.REGISTRY.counter(
        "engine.fused_traversal", kind="overflow_fallback"
    )
    before = counter.value
    monkeypatch.setenv("REPRO_FRONTIER_CAP", "1")
    got = engine.search_tree(convert.tree_from_reference(tree), queries, spec,
                             device="cpu")
    assert counter.value == before + 1
    for fld in want._fields:
        assert torch.equal(getattr(want, fld), getattr(got, fld)), fld
