"""The port's kernel functions held against the reference's `kernels.ops`.

On the CPU the port's `kernels.ops` wrappers run each kernel's plain
PyTorch version (the arithmetic the CUDA kernel repeats bitwise); the
reference runs its Pallas kernels in interpret mode. Same numpy inputs
(seeded) go through both.

Tolerances:
  * ids and slots: equal;
  * difference-form squared distances (leaf kernel): rtol 1e-6 — both
    packages sum Σ(q−c)² over D terms in f32, in different orders;
  * `topk_l2` (expansion form q²+p²−2qp in both packages): squared
    distances within 8·2⁻²⁴·(|q|²+|p|²), the cancellation bound — the
    reference's own property test fails at rtol 1e-5 near zero distance
    for the same reason.

The CUDA kernels themselves are held against these plain versions on
the card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import quantize as jquant
from repro_torch.kernels import ops, quantize
from repro_torch.kernels import topk_l2 as tk


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _leaf_inputs(seed, rows=12, c=96, d=3, dead=0.2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((rows, d)).astype(np.float32)
    cands = (q[:, None, :] + 0.7 * rng.standard_normal((rows, c, d))).astype(
        np.float32
    )
    cg = rng.permutation(rows * c).reshape(rows, c).astype(np.int32)
    cg[rng.random((rows, c)) < dead] = -1
    r = rng.uniform(0.4, 1.6, size=rows).astype(np.float32)
    return q, cands, cg, r


def _encode(cands, sdt):
    """Candidates in storage dtype for both packages. int8 runs the
    reference's encoder with each row as one leaf (one pow2 scale per
    row, broadcast to its candidates as the engine broadcasts per-leaf
    scales)."""
    if sdt == "float32":
        return jnp.asarray(cands), _t(cands), None, None
    if sdt == "bfloat16":
        return jnp.asarray(cands).astype(jnp.bfloat16), _t(cands).to(torch.bfloat16), None, None
    lq, sc, _ = jquant.quantize_leaves(cands, "int8")
    sc = np.asarray(sc)
    csc = np.broadcast_to(sc[:, None], cands.shape[:2]).astype(np.float32)
    lq_np = np.asarray(lq)
    return jnp.asarray(lq_np), _t(lq_np), jnp.asarray(csc), _t(csc)


def _assert_raw_equal(jout, tout):
    jsq, jg, js = (np.asarray(x) for x in jout)
    tsq, tg, ts = (x.numpy() for x in tout)
    fin = np.isfinite(jsq)
    assert np.array_equal(fin, np.isfinite(tsq))
    np.testing.assert_allclose(tsq[fin], jsq[fin], rtol=1e-6, atol=0)
    # the reference kernel leaves a masked candidate's gid in a filled
    # (+inf) entry; the port writes -1 there (the reference oracle's
    # convention), so ids compare on the kept entries
    assert np.array_equal(tg[fin], jg[fin])
    assert np.array_equal(ts[fin], js[fin])
    assert (tg[~fin] == -1).all() and (ts[~fin] == tk.I32_MAX).all()


@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "int8"])
def test_leaf_topk_raw_matches_reference(sdt):
    q, cands, cg, r = _leaf_inputs(1)
    jc, tc, jsc, tsc = _encode(cands, sdt)
    k = 13
    jout = jops.leaf_topk_l2_raw(
        jnp.asarray(q), jc, jnp.asarray(cg), jnp.asarray(r), k, cscale=jsc
    )
    tout = ops.leaf_topk_l2_raw(_t(q), tc, _t(cg), _t(r), k, cscale=tsc)
    _assert_raw_equal(jout, tout)


def test_leaf_topk_l2_matches_reference_with_edges():
    """f32 leaf_topk_l2 with rows that exercise every edge at once:
    r = 0, r = inf, an all-dead row, and fewer live candidates than k."""
    q, cands, cg, r = _leaf_inputs(2, rows=8, c=40, d=2)
    r[0], r[1] = 0.0, np.inf
    cg[2] = -1                       # all-dead row
    cg[3, 3:] = -1                   # 3 live candidates < k
    k = 6
    jd, jg = jops.leaf_topk_l2(
        jnp.asarray(q), jnp.asarray(cands), jnp.asarray(cg), jnp.asarray(r), k
    )
    td, tg = ops.leaf_topk_l2(_t(q), _t(cands), _t(cg), _t(r), k)
    jd, jg, td, tg = np.asarray(jd), np.asarray(jg), td.numpy(), tg.numpy()
    assert np.array_equal(jg, tg)
    fin = np.isfinite(jd)
    assert np.array_equal(fin, np.isfinite(td))
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-6, atol=0)
    assert (tg[2] == -1).all() and (tg[3, 3:] == -1).all()
    assert not np.isfinite(td[0]).any()      # r = 0: nothing within
    assert np.isfinite(td[1]).all()          # r = inf: k live always


def _expansion_bound(q, p, gids_q):
    """8·2⁻²⁴·(|q|²+|p|²) per result entry (p looked up by its id)."""
    qn = (q.astype(np.float64) ** 2).sum(1)[:, None]
    pn = (p.astype(np.float64) ** 2).sum(1)[np.clip(gids_q, 0, None)]
    return 8 * 2.0**-24 * (qn + pn)


@pytest.mark.parametrize(
    "case", ["finite_r", "inf_r_dead", "zero_r", "n_lt_k", "all_dead", "empty"]
)
def test_topk_l2_matches_reference(case):
    rng = np.random.default_rng(3)
    m, n, d, k = 10, 257, 2, 7
    if case == "n_lt_k":
        n = 4
    if case == "empty":
        n = 0
    q = rng.standard_normal((m, d)).astype(np.float32)
    p = rng.standard_normal((n, d)).astype(np.float32)
    gids = np.arange(n, dtype=np.int32)
    r = np.float32(1.1)
    if case == "inf_r_dead":
        gids[rng.random(n) < 0.3] = -1
        r = np.inf
    elif case == "zero_r":
        r = np.float32(0.0)
    elif case == "n_lt_k":
        r = np.inf
    elif case == "all_dead":
        gids[:] = -1
    jd, jg = jops.topk_l2(jnp.asarray(q), jnp.asarray(p), jnp.asarray(gids), r, k)
    td, tg = ops.topk_l2(_t(q), _t(p), _t(gids), float(r), k)
    jd, jg, td, tg = np.asarray(jd), np.asarray(jg), td.numpy(), tg.numpy()
    assert td.shape == tg.shape == (m, k)
    assert np.array_equal(jg, tg)
    fin = np.isfinite(jd)
    assert np.array_equal(fin, np.isfinite(td))
    if fin.any():
        bound = _expansion_bound(q, p, tg)[fin]
        err = np.abs(td[fin].astype(np.float64) ** 2 - jd[fin].astype(np.float64) ** 2)
        assert (err <= bound).all()
    if case in ("zero_r", "all_dead", "empty"):
        assert not fin.any() and (tg == -1).all()
    if case == "n_lt_k":
        assert fin[:, :n].all() and not fin[:, n:].any()


def test_quantized_leaf_keys_bitwise_vs_dequantized_f32():
    """The int8 path's keys are a bitwise fact of the dequantized set:
    with pow2 scales the plain version's `c * scale` is exact, so the
    raw selection over int8 equals the selection over the dequantized
    f32 candidates."""
    q, cands, cg, r = _leaf_inputs(4)
    _, tc, _, tsc = _encode(cands, "int8")
    deq = quantize.dequantize(tc, tsc)
    a = ops.leaf_topk_l2_raw(_t(q), tc, _t(cg), _t(r), 9, cscale=tsc)
    b = ops.leaf_topk_l2_raw(_t(q), deq, _t(cg), _t(r), 9)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
