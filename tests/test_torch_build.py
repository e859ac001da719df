"""The port's level-synchronous builder (`repro_torch.core.build`).

  * it meets the structural invariants every reference builder meets
    (tests/test_tree_properties.py: containment with the outward radius
    widening, leaf capacity, nested contiguous slices, a permutation);
  * on seeded random data it builds the SAME tree as the reference's
    `build_jax`: identical topology, point order and leaf buckets;
    centers and radii within 2 f32 ulps (segment sums are taken in the
    same order, the power iteration's rounding may differ);
  * searching it gives the reference's results (host oracle on the
    reference's tree, ids equal);
  * building the same points twice gives the same tree, bitwise.
"""
import numpy as np
import pytest
import torch

from repro.core import TreeSpec as JTreeSpec
from repro.core import build as jbuild
from repro.core import search_host
from repro_torch.core import TreeSpec, build
from repro_torch.core import search as sj

from test_tree_properties import check_invariants

SPECS = {
    "ballstar": TreeSpec.ballstar(leaf_size=16),
    "ball": TreeSpec.ball(leaf_size=16),
    "kd": TreeSpec.kd(leaf_size=16),
}
_TOPOLOGY = ("child_l", "child_r", "start", "count", "perm", "leaf_of_node",
             "leaf_index")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("n,d", [(700, 2), (333, 3), (200, 8)])
def test_invariants(name, n, d):
    rng = np.random.default_rng(n + d)
    pts = rng.standard_normal((n, d)).astype(np.float32)
    tree = build(pts, SPECS[name], device="cpu")
    check_invariants(tree, pts)
    leaf = tree.child_l < 0
    assert tree.count[leaf].max() <= tree.leaf_capacity


def test_degenerate_points_become_one_leaf():
    pts = np.ones((40, 2), np.float32)
    tree = build(pts, SPECS["ballstar"], device="cpu")
    assert tree.n_nodes == 1 and tree.count[0] == 40
    check_invariants(tree, pts)


def test_same_tree_as_build_jax():
    rng = np.random.default_rng(21)
    pts = rng.standard_normal((400, 2)).astype(np.float32)
    spec = dict(leaf_size=16)
    ref = jbuild(pts, JTreeSpec.ballstar(**spec), backend="jax")
    got = build(pts, TreeSpec.ballstar(**spec), device="cpu")
    for f in _TOPOLOGY:
        assert np.array_equal(getattr(ref, f), getattr(got, f)), f
    np.testing.assert_array_max_ulp(
        np.asarray(ref.center, np.float32), got.center, maxulp=2
    )
    np.testing.assert_array_max_ulp(
        np.asarray(ref.radius, np.float32),
        np.asarray(got.radius, np.float32),
        maxulp=2,
    )
    np.testing.assert_array_equal(ref.leaf_points, got.leaf_points)

    # search over the port's tree == the reference host oracle over the
    # reference's tree
    queries = rng.standard_normal((8, 2)).astype(np.float32)
    k, r = 5, 0.4
    res = sj.search(got, queries, k, r, device="cpu")
    for i, q in enumerate(queries):
        host = search_host.constrained_knn(ref, q, k, r)
        ids = res.indices[i].numpy()
        assert ids[ids >= 0].tolist() == host.indices.tolist()


def test_build_is_deterministic():
    pts = np.random.default_rng(5).standard_normal((900, 3)).astype(np.float32)
    a = build(pts, SPECS["ballstar"], device="cpu")
    b = build(pts, SPECS["ballstar"], device="cpu")
    for f in _TOPOLOGY + ("center", "radius", "points", "leaf_points"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
