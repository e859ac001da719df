"""The benchmark's files against its contract: names, units, keys, every
entry found by name from its own file, no import of JAX or the JAX
package, and no result without a card."""
import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from portbench import catalog, data, traffic
from portbench.readers import nearest_rank
from portbench.reference import brute

ROOT = catalog.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _texts():
    for key in ("configs", "workloads"):
        for e in BENCH[key]:
            yield e["why"]
    for e in BENCH["configs"]:
        yield e["source"]
    for e in BENCH["per_layer"]:
        yield e["layer"]
    yield from BENCH["command"]


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for e in BENCH["configs"]:
        assert set(e) == {"name", "source", "file", "reduced", "why"}
        assert e["file"].startswith("portbench/") and len(e["reduced"]) <= 16
    for e in BENCH["workloads"]:
        assert set(e) == {"name", "config", "traffic", "chips", "why"}
        assert e["chips"] == 1 and NAME.match(e["traffic"])
    pairs = [(e["config"], e["traffic"]) for e in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
    for e in BENCH["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert any(e["name"] == "setup_s" for e in BENCH["end_to_end"])
    for e in BENCH["per_layer"]:
        assert set(e) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for t in _texts():
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT))), path


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = catalog.cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
    assert c.traffic["mode"] in traffic.WINDOWS
    assert {"failed", "bad_ids", "sq_gap", "id_sq_gap"} <= set(c.limits)
    assert c.config["dataset"]["generator"] in data.GENERATORS


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(catalog.reader(metric))


@pytest.mark.parametrize("gen,d", [("highleyman", 2), ("highleyman", 3)])
def test_generators_repeat_from_seed(gen, d):
    seed = 2**31 + 12345
    a = data.points(gen, 1200, d, data.rng_for(seed, 0))
    b = data.points(gen, 1200, d, data.rng_for(seed, 0))
    c = data.points(gen, 1200, d, data.rng_for(seed + 1, 0))
    assert a.dtype == np.float32 and a.shape == (1200, d)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    lo, hi = a.min(0), a.max(0)
    q1 = data.uniform_queries(lo, hi, 50, data.rng_for(seed, 2))
    q2 = data.uniform_queries(lo, hi, 50, data.rng_for(seed, 2))
    assert np.array_equal(q1, q2)
    assert np.array_equal(data.rng_for(-5).random(3), data.rng_for(2**64 - 5).random(3))


def test_reference_against_a_naive_loop():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    gids = rng.permutation(1000)[:300]
    q = rng.normal(size=(20, 3)).astype(np.float32)
    k, r = 5, 0.9
    d, g = brute.constrained_knn(pts, gids, q, k, r, "cpu", chunk=7)
    for i in range(len(q)):
        dist = [float(np.sqrt(((q[i].astype(np.float64) - p.astype(np.float64)) ** 2).sum()))
                for p in pts]
        order = sorted((x, j) for j, x in enumerate(dist) if x <= r)[:k]
        want_d = [x for x, _ in order] + [np.inf] * (k - len(order))
        want_g = [gids[j] for _, j in order] + [-1] * (k - len(order))
        assert np.allclose(d[i], want_d, rtol=1e-12, atol=0) and list(g[i]) == want_g
    dc, gc = brute.constrained_knn(pts, gids, q, k, r, "cpu", dtype=__import__("torch").bfloat16)
    assert dc.shape == d.shape and not np.array_equal(dc, d)


def test_rate_and_p95_arithmetic():
    from portbench.harness import Ctx

    rate = catalog.reader("queries_per_s")
    ctx = Ctx(None, 1.0, {"batches": 3, "queries": 300, "failed": 0, "seconds": 2.5})
    assert rate(ctx) == 300 / 2.5   # all the work over all the time
    p95 = catalog.reader("serve_p95_ms")
    lat = np.arange(1, 101, dtype=float)   # 1..100 ms
    w = {"latency_ms": lat, "seconds": 10.0, "wait_s": 60.0}
    assert p95(Ctx(None, 1.0, w)) == 95.0   # nearest rank, no interpolation
    lat[0] = np.inf   # a failed request is slower than any reply
    assert p95(Ctx(None, 1.0, dict(w, latency_ms=lat))) == 96.0
    lat[:6] = np.inf
    assert p95(Ctx(None, 1.0, dict(w, latency_ms=lat))) > lat[np.isfinite(lat)].max()
    assert nearest_rank([3.0], 95.0) == 3.0
    ups = catalog.reader("updates_per_s")
    assert ups(Ctx(None, 1.0, {"acked": 5000, "seconds": 2.0})) == 2500.0


def test_arrivals_fixed_count_other_order():
    tr = {"rate_per_s": 50.0}
    a = traffic.arrival_offsets(tr, 10.0, data.rng_for(1, 4))
    b = traffic.arrival_offsets(tr, 10.0, data.rng_for(2, 4))
    assert len(a) == len(b) and not np.array_equal(a, b)
    assert 400 < len(a) < 600   # about rate x seconds
    assert a[0] == 0.0 and a[-1] < 10.0 and np.all(np.diff(a) >= 0)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    forbidden = {"jax", "jaxlib", "flax", "repro"}
    for path in (ROOT / "portbench").rglob("*.py"):
        found = set(_imports(path)) & forbidden
        assert not found, (path, found)
        assert "benchmarks" not in set(_imports(path)), path
    # and what the harness loads in its process, by whole top-level names
    code = ("import sys; sys.path.insert(0, %r); from portbench import harness; "
            "harness.prepare_env(%r); import repro_torch.index, repro_torch.serve.frontend; "
            "from portbench import devtrace, compare, tools; "
            "print(harness.forbidden_modules())" % (str(ROOT), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={k: v for k, v in os.environ.items()
                                           if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_command_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path cannot be driven here")
    out = subprocess.run(
        [sys.executable, *BENCH["command"][1:], "--workload", "hl2d-bulk", "--seed",
         "4294967311", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
