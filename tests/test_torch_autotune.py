"""The port's launch-geometry autotuner (`repro_torch.kernels.autotune`)
against the reference's `kernels/autotune.py`: the shape classes and the
`REPRO_BLOCK_PLAN` grammar equal (errors included), the per-class cache,
the measured mode, the `decisions()` export, a decision recorded per
kernel by the ops wrappers, and no result depending on the plan — the
plain version of `topk_l2` run under every candidate split answers
bitwise as it does whole.
"""
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch.kernels import autotune as at
from repro_torch.kernels import ops
from repro_torch.kernels import topk_l2 as tk


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    monkeypatch.delenv("REPRO_BLOCK_PLAN", raising=False)
    at.reset()
    yield
    at.reset()


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 5, 2), (64, 4096, 2),
                                   (5300, 4096, 2), (4, 257, 32), (8192, 1, 129)])
def test_shape_class_equals_reference(shape):
    assert at.shape_class(*shape) == jat.shape_class(*shape)


@pytest.mark.parametrize("value", ["", "8x128", "8x128x256", "16x512", "32X256",
                                   "foo", "7x128", "32x100", "8x128x100", "0x128",
                                   "32", "8x128x256x1", "8xa"])
def test_block_plan_env_equals_reference(value):
    try:
        want = jat.parse_block_plan_env(value)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            at.parse_block_plan_env(value)
        assert str(got.value) == str(e)
    else:
        assert at.parse_block_plan_env(value) == want


def test_cache_is_per_shape_class():
    a = at.choose_plan("topk_l2", 300, 3000, 2, 8)
    b = at.choose_plan("topk_l2", 400, 2100, 2, 8)  # same pow2 class
    assert a is b
    c = at.choose_plan("topk_l2", 800, 3000, 2, 8)  # another class
    assert c is not a
    assert at.choose_plan("topk_l2", 300, 3000, 2, 8, dtype="float32",
                          backend="cuda") is not at.choose_plan(
        "topk_l2", 300, 3000, 2, 8, dtype="float32", backend="cpu")


def test_main_path_choice_is_todays_geometry():
    """At the main path's shapes (N = 4,096, k = 10) the model ranks the
    split `scan_geometry` chose before the tuner existed first: 16 splits
    of 256 at Q = 64, the whole arena at Q = 5,300 (whose 663 query
    groups outnumber a stream's ticket counters: one candidate)."""
    for m, n in ((64, 4096), (5300, 4096)):
        plan = at.choose_plan("topk_l2", m, n, 2, 10, backend="cuda")
        assert plan["bn"] == tk.scan_geometry(m, n, 10)["split"]
        assert plan["source"] == "analytic"
    assert len(at.ranked("topk_l2", 5300, 4096, 2, 10)) == 1
    assert len(at.ranked("topk_l2", 64, 4096, 2, 10)) == 7


def test_candidates_are_whole_steps_and_fit():
    for m, n, k in ((1, 4096, 10), (64, 4096, 10), (64, 4097, 32), (3, 70, 1)):
        plans = at.ranked("topk_l2", m, n, 2, k)
        assert tk.scan_geometry(m, n, k)["split"] in [p["bn"] for p in plans]
        for p in plans:
            assert p["bn"] % 64 == 0 and p["bn"] <= -(-n // 64) * 64
            assert p["vmem_bytes"] <= at.SMEM_BUDGET
        assert [p["score"] for p in plans] == sorted(p["score"] for p in plans)
    # k > 32: the shared-memory list takes one split
    assert [p["bn"] for p in at.ranked("topk_l2", 64, 4096, 2, 40)] == [4096]


def test_pin_resolves_through_the_planner(monkeypatch):
    monkeypatch.setenv("REPRO_BLOCK_PLAN", "32x512")
    plan = at.choose_plan("topk_l2", 64, 4096, 2, 10)
    assert plan["source"] == "env"
    # 8 queries a block and D are compiled in / given: the plan records them
    assert (plan["bm"], plan["bn"], plan["bk"]) == (8, 512, 2)
    at.reset()
    monkeypatch.setenv("REPRO_BLOCK_PLAN", "8x32")  # below one step of 64
    assert at.choose_plan("topk_l2", 64, 4096, 2, 10)["bn"] == 64
    assert at.choose_plan("topk_l2", 64, 4096, 2, 40)["bn"] == 4096  # one split
    leaf = at.choose_plan("leaf_topk_l2", 64, 1024, 2, 18, dtype="bfloat16")
    assert (leaf["bm"], leaf["bn"], leaf["bk"], leaf["source"]) == (8, 1024, 2, "env")
    monkeypatch.setenv("REPRO_BLOCK_PLAN", "7x128")
    with pytest.raises(ValueError):
        at.choose_plan("topk_l2", 64, 4096, 2, 10)


def test_measured_mode_keeps_the_fastest():
    times = {}

    def fake_measure(plan):
        t = 1.0 / plan["bn"]  # wider splits "run faster": inverts the model
        times[plan["bn"]] = t
        return t

    plan = at.choose_plan("topk_l2", 64, 4096, 2, 10, measure=fake_measure, trials=3)
    assert plan["source"] == "measured"
    assert len(times) == 3
    assert plan["measured_us"] == min(times.values()) * 1e6
    assert plan["bn"] == max(times)
    assert at.choose_plan("topk_l2", 64, 4096, 2, 10)["source"] == "analytic"


def test_decisions_export_schema():
    at.choose_plan("topk_l2", 512, 4096, 2, 8)
    at.choose_plan("leaf_topk_l2", 64, 1024, 16, 8, dtype="int8")
    at.choose_plan("pairwise_sq_l2", 100, 300, 20, dtype="bfloat16")
    at.choose_plan("cov_matvec", 1000, 3, 3)
    dec = at.decisions()
    assert set(dec) == {"topk_l2/512x4096x2/k8/float32/cpu",
                        "leaf_topk_l2/64x1024x16/k8/int8/cpu",
                        "pairwise_sq_l2/128x512x32/k0/bfloat16/cpu",
                        "cov_matvec/1024x4x4/k0/float32/cpu"}
    for key, plan in dec.items():
        assert set(plan) == {"bm", "bn", "bk", "grid", "blocks", "padded_flops",
                             "stream_bytes", "vmem_bytes", "pred_us", "source"}
        for field in ("bm", "bn", "bk", "blocks"):
            assert isinstance(plan[field], int) and plan[field] > 0
        for field in ("padded_flops", "stream_bytes", "vmem_bytes", "pred_us"):
            assert plan[field] >= 0
        assert plan["source"] == "analytic"
        assert all(isinstance(x, int) for x in plan["grid"])
        assert sum(plan["grid"]) == plan["blocks"]


def test_ops_wrappers_record_a_decision_per_kernel():
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, cands = f(5, 2), f(5, 40, 2)
    cg = torch.arange(200, dtype=torch.int32).reshape(5, 40)
    ops.leaf_topk_l2_raw(q, cands.to(torch.bfloat16), cg, 1.0, 6)
    ops.leaf_topk_l2(q, cands, cg, 1.0, 6)
    ops.topk_l2(q, f(300, 2), torch.arange(300, dtype=torch.int32), 1.0, 6)
    ops.pairwise_sq_l2(f(9, 3), f(11, 3))
    ops.power_iteration(f(50, 3), iters=2)
    kernels = {key.split("/")[0]: key for key in at.decisions()}
    assert set(kernels) == {"leaf_topk_l2", "topk_l2", "pairwise_sq_l2", "cov_matvec"}
    assert all(key.endswith("/cpu") for key in kernels.values())
    dtypes = {key.split("/")[3] for key in at.decisions() if key.startswith("leaf")}
    assert dtypes == {"bfloat16", "float32"}


@pytest.mark.parametrize("m,n,k", [(1, 4096, 10), (64, 4096, 10), (37, 2100, 11),
                                   (64, 4097, 32), (5, 70, 1), (9, 300, 64)])
def test_topk_plain_result_is_the_same_for_every_candidate_split(m, n, k):
    rng = np.random.default_rng(n + k)
    q = torch.from_numpy(rng.standard_normal((m, 2)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32))
    # duplicate points: equal keys tie on the slot across splits
    dup = min(40, n // 2)
    p[n - dup:] = p[:dup]
    g = np.where(rng.random(n) < 0.2, -1, np.arange(n)).astype(np.int32)
    g = torch.from_numpy(g)
    r_sq = tk.radius_sq_upper(torch.full((m,), 1.5))
    want = tk.topk_plain(q, p, g, r_sq, k)
    plans = at.ranked("topk_l2", m, n, 2, k)
    for plan in plans:
        got = tk.topk_plain(q, p, g, r_sq, k, split=plan["bn"])
        for x, y in zip(got, want):
            assert torch.equal(x, y), plan["bn"]
