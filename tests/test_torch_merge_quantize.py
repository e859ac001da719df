"""The port's merge primitive and quantized encodings vs the reference.

  * merge: tie-heavy candidate lists (coordinates rounded to a coarse
    grid, as in tests/test_kernels.py) come out in the reference's order
    — `lax.top_k` breaks ties toward the lower slot and the cross-rank
    merge lets the first part win ties; the port must reproduce both
    (torch.topk promises no tie order, so the port sorts stably);
  * quantize: bf16 and int8 encodings, scales and `qerr` are bitwise
    the reference's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import quantize as jquant
from repro.query import merge as jmerge
from repro_torch.kernels import quantize
from repro_torch.query import merge


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tied_lists(seed, rows=6, width=24):
    """Sorted (distance, id) lists with many exact ties: squared grid
    distances of rounded coordinates."""
    rng = np.random.default_rng(seed)
    pts = np.round(rng.standard_normal((rows, width, 2)) * 2) / 2
    d = np.sqrt((pts**2).sum(-1)).astype(np.float32)
    ids = rng.permutation(rows * width).reshape(rows, width).astype(np.int32)
    return d, ids


def test_topk_sorted_ties_to_lower_slot():
    d, ids = _tied_lists(0)
    for k in (1, 5, 24, 30):
        jd, ji = jmerge.topk_sorted(jnp.asarray(d), jnp.asarray(ids), k)
        td, ti = merge.topk_sorted(torch.from_numpy(d), torch.from_numpy(ids), k)
        assert np.array_equal(np.asarray(jd), td.numpy())
        assert np.array_equal(np.asarray(ji), ti.numpy())


@pytest.mark.parametrize("n_parts", [2, 3, 5])
def test_merge_parts_tie_order(n_parts):
    rng = np.random.default_rng(n_parts)
    k = 7
    jparts, tparts = [], []
    for p in range(n_parts):
        d, ids = _tied_lists(10 + p, width=int(rng.integers(3, 12)))
        d, ids = np.sort(d, axis=1, kind="stable"), ids
        jparts.append((jnp.asarray(d), jnp.asarray(ids)))
        tparts.append((torch.from_numpy(d), torch.from_numpy(ids)))
    jd, ji = jmerge.merge_parts(jparts, k)
    td, ti = merge.merge_parts(tparts, k)
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert np.array_equal(np.asarray(ji), ti.numpy())


def test_merge_sorted_and_vals_match():
    da, ia = _tied_lists(20, width=9)
    db, ib = _tied_lists(21, width=5)
    da, db = np.sort(da, 1), np.sort(db, 1)
    jd, ji = jmerge.merge_sorted(*map(jnp.asarray, (da, ia, db, ib)))
    td, ti = merge.merge_sorted(*map(torch.from_numpy, (da, ia, db, ib)))
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert np.array_equal(np.asarray(ji), ti.numpy())
    jv = jmerge.merge_sorted_vals(jnp.asarray(da), jnp.asarray(db))
    tv = merge.merge_sorted_vals(torch.from_numpy(da), torch.from_numpy(db))
    assert np.array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("sdt", ["bfloat16", "int8", "float32"])
def test_quantize_leaves_bitwise(sdt):
    rng = np.random.default_rng(7)
    # leaves of mixed magnitude, a zero leaf, and values that sit on
    # bf16 rounding midpoints
    lp = (rng.standard_normal((9, 8, 3)) * rng.uniform(0.01, 50, (9, 1, 1)))
    lp[3] = 0.0
    lp[4, 0, 0] = 1.0 + 2.0**-8  # bf16 tie: round to even
    lp = lp.astype(np.float32)
    jq, js, je = jquant.quantize_leaves(lp, sdt)
    tq, ts, te = quantize.quantize_leaves(torch.from_numpy(lp), sdt)
    assert je == te
    if sdt == "float32":
        assert jq is None and tq is None and js is None and ts is None
        return
    jq_np = np.asarray(jnp.asarray(jq).view(jnp.int16)) if sdt == "bfloat16" \
        else np.asarray(jq)
    tq_np = tq.view(torch.int16).numpy() if sdt == "bfloat16" else tq.numpy()
    assert np.array_equal(jq_np, tq_np)  # bit patterns
    if sdt == "int8":
        assert np.array_equal(np.asarray(js), ts.numpy())
        deq_j = np.asarray(jquant.dequantize(jq, js))
        assert np.array_equal(deq_j, quantize.dequantize(tq, ts).numpy())
    else:
        assert js is None and ts is None
