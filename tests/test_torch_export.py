"""The port's `obs/export` against the reference's, and the quantized
stream counters both packages' `kernels.ops` bill.

The same counters, gauges and histogram observations go into both
packages' `Registry`; `to_payload`'s `obs` and `quantized` sections and
`table()` must be equal after a JSON round trip (the `autotune` sections
hold each package's own plans). The counter test makes the same raw and
non-raw leaf calls through both packages' `ops`: the reference's kernel
is stubbed (its wrapper bills before it launches, and a Pallas compile
per storage type would be the test's whole cost), the port's runs its
plain version.
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import obs as jobs
from repro.kernels import ops as jops
from repro.kernels import topk_l2 as jtk
from repro_torch import obs
from repro_torch.kernels import autotune as at
from repro_torch.kernels import ops


def _fill(reg):
    reg.counter("engine.dispatches", kind="traversal").inc(7)
    reg.counter("engine.dispatches", kind="brute").inc(2)
    reg.counter("quantized.stream_bytes", dtype="bfloat16").inc(4096)
    reg.counter("quantized.f32_stream_bytes", dtype="bfloat16").inc(8192)
    reg.counter("quantized.stream_bytes", dtype="int8").inc(300)
    reg.counter("quantized.f32_stream_bytes", dtype="int8").inc(960)
    reg.counter("quantized.rescore", result="exact").inc(11)
    reg.counter("quantized.rescore", result="fallback").inc(3)
    reg.gauge("index.delta_occupancy", index="idx0").set(0.4375)
    reg.gauge("autotune.bn", kernel="topk_l2", cls="64x4096x2", k=10).set(256)
    h = reg.histogram("span.serve.search", unit="s")
    for v in (1e-4, 3e-4, 2.5e-3, 0.0125, 0.5):
        h.observe(v)
    reg.histogram("search.nodes_visited", unit="nodes").observe(1234)
    reg.histogram("empty.one", unit="1")


def _round_trip(payload):
    return json.loads(json.dumps(payload))


def test_payload_and_table_equal_to_reference(tmp_path):
    reg, jreg = obs.Registry(), jobs.Registry()
    _fill(reg)
    _fill(jreg)
    got = _round_trip(obs.export.to_payload(reg))
    want = _round_trip(jobs.export.to_payload(jreg))
    assert got["section"] == want["section"] == "obs"
    assert got["obs"] == want["obs"]
    assert got["quantized"] == want["quantized"]
    assert got["quantized"]["bfloat16"]["reduction_factor"] == 2.0
    assert got["quantized"]["int8"]["rescore_fallback"] == 3
    assert obs.export.table(got["obs"]) == jobs.export.table(want["obs"])
    assert obs.export.table(obs.Registry().snapshot()) == "(registry empty)"
    path = obs.export.dump_json(str(tmp_path / "BENCH_obs.json"), reg)
    back = obs.export.load_json(path)
    assert set(back) == {"section", "generated_unix", "obs", "autotune", "quantized"}
    assert back["obs"] == got["obs"] and back["quantized"] == got["quantized"]


def test_payload_carries_the_autotune_decisions():
    at.reset()
    try:
        at.choose_plan("topk_l2", 64, 4096, 2, 10, backend="cuda")
        payload = _round_trip(obs.export.to_payload(obs.Registry()))
        assert list(payload["autotune"]) == ["topk_l2/64x4096x2/k10/float32/cuda"]
        assert payload["autotune"]["topk_l2/64x4096x2/k10/float32/cuda"]["bn"] == 256
    finally:
        at.reset()


def _leaf_inputs(sdt, rows=6, c=40, d=3, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((rows, d)).astype(np.float32)
    cands = (q[:, None, :] + rng.standard_normal((rows, c, d))).astype(np.float32)
    cg = np.arange(rows * c, dtype=np.int32).reshape(rows, c)
    if sdt == "int8":
        scale = np.full((rows, c), 2.0 ** -5, np.float32)
        store = np.clip(np.round(cands / scale[..., None]), -127, 127).astype(np.int8)
        return q, store, cg, scale
    return q, cands, cg, None


def _reference_calls(monkeypatch, calls):
    """The reference's wrappers with its kernels stubbed: billing only."""
    def stub(q, cands, cgids, r, k, **kw):
        return None

    monkeypatch.setattr(jtk, "leaf_topk_l2_raw", stub)
    monkeypatch.setattr(jtk, "leaf_topk_l2", stub)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
    for raw, sdt, (q, cands, cg, scale) in calls:
        args = (jnp.asarray(q), jnp.asarray(cands).astype(jdt[sdt]), jnp.asarray(cg), 1.0, 8)
        if raw:
            jops.leaf_topk_l2_raw(*args, cscale=None if scale is None else jnp.asarray(scale))
        else:
            jops.leaf_topk_l2(*args)


def _port_calls(calls):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
    for raw, sdt, (q, cands, cg, scale) in calls:
        args = (torch.from_numpy(q), torch.from_numpy(cands).to(tdt[sdt]),
                torch.from_numpy(cg), 1.0, 8)
        if raw:
            ops.leaf_topk_l2_raw(*args, cscale=None if scale is None
                                 else torch.from_numpy(scale))
        else:
            ops.leaf_topk_l2(*args)


def _quantized(snapshot):
    """The quantized counters billed since the last reset (a reset zeroes
    a counter in place and keeps its key)."""
    return {k: v for k, v in snapshot["counters"].items()
            if k.startswith("quantized.") and v}


def test_quantized_stream_counters_equal_reference_keys(monkeypatch):
    """Raw calls bill `quantized.stream_bytes{dtype}` and
    `quantized.f32_stream_bytes{dtype}`, the f32 `leaf_topk_l2` neither —
    the same keys in both packages. The port's bytes are its own stream
    (candidates at storage width, plus the int8 scale): the f32 / stream
    ratio is 2 for bf16, 4·D/(D+4) for int8 and 1 for f32."""
    d = 3
    calls = [(True, sdt, _leaf_inputs(sdt, d=d, seed=i))
             for i, sdt in enumerate(("float32", "bfloat16", "int8"))]
    calls += [(False, "float32", _leaf_inputs("float32", d=d, seed=5))]
    jobs.REGISTRY.reset()
    obs.REGISTRY.reset()
    try:
        _reference_calls(monkeypatch, calls)
        _port_calls(calls)
        want = _quantized(jobs.snapshot())
        got = _quantized(obs.snapshot())
        assert set(got) == set(want)
        assert set(got) == {f"quantized.{what}{{dtype={dt}}}"
                            for what in ("stream_bytes", "f32_stream_bytes")
                            for dt in ("float32", "bfloat16", "int8")}
        summary = obs.export.quantized_summary()
        assert set(summary) == set(jobs.export.quantized_summary())
        assert summary["float32"]["reduction_factor"] == 1.0
        assert summary["bfloat16"]["reduction_factor"] == 2.0
        assert summary["int8"]["reduction_factor"] == pytest.approx(4 * d / (d + 4), rel=1e-12)
        rows, c = 6, 40
        assert summary["bfloat16"]["bytes_quantized"] == rows * c * d * 2
        assert summary["int8"]["bytes_quantized"] == rows * c * (d + 4)
    finally:
        jobs.REGISTRY.reset()
        obs.REGISTRY.reset()
