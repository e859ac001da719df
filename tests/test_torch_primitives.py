"""The port's kernel primitives held against the reference's `kernels.ops`.

On the CPU the port's `kernels.ops` wrappers run each kernel's plain
PyTorch version (the arithmetic its CUDA kernel repeats bitwise); the
reference runs its Pallas kernels in interpret mode. The same seeded
numpy inputs go through both; bf16 inputs are rounded once, by JAX, and
handed to the port as the same bf16 values.

Tolerances are the reference tests' own (tests/test_kernels.py):
  * pairwise_sq_l2 / lower_bounds: rtol = atol = 1e-4 in f32, 5e-2 in
    bf16 — both packages use the expansion form, summed in different
    orders (the cancellation near zero distance is absolute, so atol);
  * cov_matvec: rtol 1e-3 (f32) / 1e-1 (bf16), atol the same fraction
    of max|y|;
  * power_iteration: |cos| > 0.999 against the exact eigenvector and
    against the reference's result (the start vectors differ: a
    `torch.Generator` draw here, `jax.random` there).

The CUDA kernels themselves are held against these plain versions on
the card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.pca import first_component_exact as j_exact
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import first_component_exact
from repro_torch.kernels import cov_matvec as cm
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_l2 as pw
from repro_torch.kernels import topk_l2 as tk

_DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _both(a, name):
    """`a` rounded to `name` once (by JAX), as (jax array, torch tensor)."""
    jdt, tdt = _DTYPES[name]
    j = jnp.asarray(a, jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


@pytest.mark.parametrize("m,n,d", [(129, 127, 3), (200, 50, 64), (33, 65, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pairwise_sq_l2_matches_reference(m, n, d, dtype):
    rng = np.random.default_rng(m * 1000 + n + d)
    jq, q = _both(rng.standard_normal((m, d)), dtype)
    jp, p = _both(rng.standard_normal((n, d)), dtype)
    got = ops.pairwise_sq_l2(q, p)
    want = np.asarray(jops.pairwise_sq_l2(jq, jp))
    tol = 1e-4 if dtype == "float32" else 5e-2
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    assert (got >= 0).all()
    # pairwise_l2 is its square root; the plain version is the kernel's
    # expansion form, which ops ran here (CPU tensors launch nothing)
    assert torch.equal(ops.pairwise_l2(q, p), torch.sqrt(got))
    assert torch.equal(got, pw.pairwise_plain(q, p))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lower_bounds_matches_reference(dtype):
    rng = np.random.default_rng(5)
    jq, q = _both(rng.standard_normal((10, 3)), dtype)
    jc, c = _both(rng.standard_normal((20, 3)), dtype)
    r = rng.uniform(0.1, 1.0, 20).astype(np.float32)
    got = ops.lower_bounds(q, c, torch.from_numpy(r)).numpy()
    want = np.asarray(jops.lower_bounds(jq, jc, jnp.asarray(r)))
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert (got >= 0).all() and (got == 0).any() and (got > 0).any()


@pytest.mark.parametrize("n,d", [(517, 130), (1024, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cov_matvec_matches_reference(n, d, dtype):
    rng = np.random.default_rng(n + d)
    jx, x = _both(rng.standard_normal((n, d)), dtype)
    jmean = jnp.mean(jx.astype(jnp.float32), axis=0).astype(_DTYPES[dtype][0])
    _, mean = _both(np.asarray(jmean.astype(jnp.float32)), dtype)
    jw, w = _both(rng.standard_normal(d), dtype)
    got = ops.cov_matvec(x, mean, w)
    want = np.asarray(jops.cov_matvec(jx, jmean, jw))
    tol = 1e-3 if dtype == "float32" else 1e-1
    assert got.dtype == torch.float32 and got.shape == (d,)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max()))
    )


@pytest.mark.parametrize("n,d", [(1, 1), (10, 2), (300, 3), (70_000, 2)])
def test_cov_matvec_plain_sum_order(n, d):
    """The plain version's block / group / tree partition of the sum
    (shape-only, so y never depends on the card) covers every row once:
    within the f32 bound of a sum whose longest chain is
    rows_per_block/groups + log2(groups) + blocks + 8 additions."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, d)).astype(np.float32) + 3.0
    mean = x.mean(0)
    w = rng.standard_normal(d).astype(np.float32)
    got = ops.cov_matvec(torch.from_numpy(x), torch.from_numpy(mean),
                         torch.from_numpy(w)).numpy()
    xc = x.astype(np.float64) - mean
    want = xc.T @ (xc @ w)
    rows, blocks, groups = cm.geometry(n, d)
    chain = rows // groups + groups.bit_length() + blocks + 8 + d
    scale = np.abs(xc).T @ (np.abs(xc) @ np.abs(w))
    assert (np.abs(got - want) <= 2 * chain * 2.0**-24 * scale + 1e-30).all()


def _wide_case(dtype, n=33, d=2049, seed=11):
    """33 rows of 2,049 values (the kernel's wide route on the card), one
    dominant direction; x rounded to `dtype` once."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) + 1.5
    x[:, 0] *= 6.0
    x[:, 1] *= 3.0
    jx, tx = _both(x, dtype)
    mean = tx.float().mean(0)
    return jx, tx, mean


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cov_matvec_wide_rows_match_reference(dtype):
    """D = 2,049: the plain version against the reference's
    `kernels/ref.py cov_matvec` (XLA's f32 products). Tolerance: each of
    the two computes two f32 dot products with chains of at most N + D
    additions, so each lies within (N + D)·2⁻²⁴·s of the exact value,
    s = |Xc|ᵀ(|Xc||w|); they are held to twice that."""
    jx, x, mean = _wide_case(dtype)
    n, d = x.shape
    w = torch.from_numpy(np.random.default_rng(12).standard_normal(d).astype(np.float32))
    got = ops.cov_matvec(x, mean, w).numpy()
    want = np.asarray(jref.cov_matvec(jx, jnp.asarray(mean.numpy()), jnp.asarray(w.numpy())))
    xc = np.abs(x.float().numpy().astype(np.float64) - mean.numpy())
    scale = xc.T @ (xc @ np.abs(w.numpy()))
    assert got.shape == (d,) and got.dtype == np.float32
    assert (np.abs(got - want) <= 2 * (n + d) * 2.0**-24 * scale).all()


def test_power_iteration_wide_rows_match_reference_steps():
    """D = 2,049: `ops.power_iteration` against the same 16 steps taken
    with the reference's `ref.cov_matvec` from the same start vector (the
    step's f32 reordering, ≤ 1e-4 per entry of the unit vector), and
    |cos| > 0.999 against the exact eigenvector."""
    jx, x, mean = _wide_case("float32")
    d = x.shape[1]
    w = ops.power_iteration(x, iters=16, generator=torch.Generator().manual_seed(4))
    v = torch.randn(d, generator=torch.Generator().manual_seed(4)).numpy()
    v = v / np.linalg.norm(v)
    jmean = jnp.asarray(mean.numpy())
    for _ in range(16):
        y = np.asarray(jref.cov_matvec(jx, jmean, jnp.asarray(v)))
        v = y / np.linalg.norm(y)
    assert np.abs(w.numpy() - v).max() <= 1e-4
    assert abs(float(np.dot(w.numpy(), first_component_exact(x.numpy())))) > 0.999


def test_power_iteration_matches_eigh_and_reference():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((400, 6)) @ np.diag([5, 2, 1, 0.5, 0.2, 0.1])).astype(
        np.float32
    )
    gen = torch.Generator().manual_seed(3)
    w = ops.power_iteration(torch.from_numpy(x), iters=40, generator=gen).numpy()
    we = first_component_exact(x)
    np.testing.assert_array_equal(we, j_exact(x))
    jw = np.asarray(jops.power_iteration(jnp.asarray(x), iters=40))
    assert abs(float(np.dot(w, we))) > 0.999
    assert abs(float(np.dot(w, jw))) > 0.999
    assert abs(float(np.linalg.norm(w)) - 1.0) < 1e-5


def test_power_iteration_bf16_and_default_generator():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((300, 4)) @ np.diag([4, 1, 0.5, 0.1])).astype(np.float32)
    we = first_component_exact(x)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    w = ops.power_iteration(xb, iters=30)
    assert w.dtype == torch.float32
    assert abs(float(np.dot(w.numpy(), we))) > 0.999
    # no generator: a fresh one seeded 0, so the result is reproducible
    assert torch.equal(w, ops.power_iteration(xb, iters=30))


def test_power_iteration_degenerate_returns_start_vector():
    x = torch.full((50, 4), 1.5)
    w = ops.power_iteration(x, iters=16, generator=torch.Generator().manual_seed(9))
    w0 = torch.randn(4, generator=torch.Generator().manual_seed(9))
    assert torch.equal(w, w0 / torch.linalg.vector_norm(w0))


def test_split_groups_fit_one_stream_of_tickets():
    """topk_l2 splits the arena only for fewer query groups than a
    stream's ticket buffer holds (one counter a group), so the buffer is
    never too short and is never replaced."""
    from repro_torch.kernels import cuda_lib

    widest = 0
    for m in list(range(1, 2200, 3)) + [2104, 2105, 2111, 2112, 2113, 5300]:
        for n in (1, 257, 4096, 65_536):
            for k in (1, 10, 32, 33):
                geo = tk.scan_geometry(m, n, k)
                if geo["splits"] > 1:
                    widest = max(widest, geo["groups"])
    assert widest == cuda_lib.TICKETS - 1


def test_plans_and_launch_counts():
    plan = pw.block_plan(130, 65, 3, itemsize=2)
    assert plan["route"] == "cuda_core" and plan["tile"] == (64, 256)
    assert plan["grid"] == (3,) and plan["blocks"] == 3
    wide = pw.block_plan(4096, 65536, pw.WIDE_MIN_D, itemsize=4)
    assert wide["route"] == "wgmma_tf32x3"
    # the prep pass (one row of [q; p] per thread), then 32 x 512 tiles
    assert wide["grid"] == ((4096 + 65536) // 256, 32 * 512)
    assert pw.block_plan(3, 5, 128, itemsize=2)["route"] == "wgmma_bf16"
    assert pw.route(pw.WIDE_MIN_D - 1) == "cuda_core"
    assert plan["flops"] == 2 * 130 * 65 * 3 + 2 * (130 + 65) * 3
    assert plan["hbm_bytes"] == (130 + 65) * 3 * 2 + 4 * 130 * 65
    # one launch: 245 blocks of one 2,048-row tile each (128 row groups);
    # the last block to finish folds the partials
    rows, blocks, groups = cm.geometry(500_000, 2)
    assert (rows, blocks, groups) == (2048, 245, 128)
    assert cm.tile_rows(2) == 2048 and cm.geometry(100_000, 64) == (384, 261, 4)
    assert cm.row_lanes(2) == 1 and cm.row_lanes(64) == 4
    assert cm.block_plan(500_000, 2) == {
        "blocks": 245, "flops": 4 * 500_000 * 2, "hbm_bytes": 500_000 * 2 * 4 + 24
    }
    # topk_l2: the |p|² pre-pass, then query groups × arena splits
    assert tk.scan_geometry(64, 4096, 10) == {
        "ppl": 2, "split": 256, "groups": 8, "splits": 16}
    assert tk.scan_geometry(5300, 4096, 10) == {
        "ppl": 2, "split": 4096, "groups": 663, "splits": 1}
    assert tk.scan_geometry(64, 4096, 33)["splits"] == 1
    # D = 2: 4,096 records + one step of 64 for the prefetch: 17 blocks
    assert tk.block_plan(64, 4096, 2, 10)["grid"] == (17, 8 * 16)
    ops.reset_launch_counts()
    ops.pairwise_sq_l2(torch.ones(3, 2), torch.zeros(4, 2))
    ops.power_iteration(torch.rand(20, 3), iters=2)
    counts = ops.launch_counts()
    assert set(counts) >= {"pairwise_sq_l2", "cov_matvec", "leaf_topk", "topk_l2"}
    assert not any(counts.values())  # the CPU runs the plain versions
