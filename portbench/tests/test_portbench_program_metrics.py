"""The per-layer metrics that read the program's own spans and counters:
a small traced run of each cell on the CPU reads every one of its
metrics that needs no device, and the readers return nothing, without
raising, for a program that lacks those spans and counters."""
import json

import pytest

from portbench import catalog
from portbench.harness import Ctx

BENCH = json.loads((catalog.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
WRITE = ("write.seal_ms_per_1k.updates", "write.merge_ms_per_1k.updates",
         "write.wal_ms_per_1k.updates")
NEW = WRITE + ("frontend.queue_wait_ms.serve", "frontend.respond_ms.serve",
               "phase1.iters.bulk", "phase1.lane_occupancy.bulk",
               "phase1.lane_occupancy.updates")


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_every_program_metric(small_run, cell):
    res = small_run(cell, trace=True)
    assert res["correct"] is True
    got = res["metrics"]
    # a device trace reads only on a card; everything else reads here
    want = {m["name"] for m in catalog.cell(cell).per_layer
            if m["source"] != "device_trace"}
    assert want <= set(got), sorted(want - set(got))
    for name in want:
        assert got[name]["value"] >= 0.0, name
    if cell == "hl2d-updates":
        # the spans sit inside the harness's own timers of add and delete
        parts = sum(got[n]["value"] for n in WRITE)
        assert 0.0 < parts <= got["write.ms_per_1k.updates"]["value"]
        assert 0.0 < got["phase1.lane_occupancy.updates"]["value"] <= 100.0
    if cell == "hl2d-bulk":
        assert got["phase1.iters.bulk"]["value"] >= 8
        assert 0.0 < got["phase1.lane_occupancy.bulk"]["value"] <= 100.0


def _ctx(span_s, counters, **window):
    return Ctx(None, 1.0, window, {"span_s": span_s, "counters": counters})


@pytest.mark.parametrize("name", NEW)
def test_program_without_the_spans_reads_nothing(name):
    """The registry of a program before these spans and counters: its
    other spans and counters only."""
    ctx = _ctx({"engine.dispatch": 1.0, "search.phase1": 2.0},
               {"search.host_syncs{site=loop}": 9, "serve.frontend.requests": 4,
                "serve.frontend.dispatches{qclass=4}": 1},
               updates=2000, batches=1, seconds=1.0)
    assert catalog.reader(name)(ctx) is None


def test_write_metrics_read_zero_for_a_span_not_opened():
    ctx = _ctx({"index.add": 0.5, "index.delete": 0.25, "index.wal_append": 0.02,
                "index.merge{kind=tiered}": 0.1, "index.merge{kind=purge}": 0.05},
               {}, updates=4000)
    read = {n: catalog.reader(n)(ctx) for n in WRITE}
    assert read["write.seal_ms_per_1k.updates"] == 0.0   # no seal in the window
    assert read["write.merge_ms_per_1k.updates"] == pytest.approx(150.0 / 4)
    assert read["write.wal_ms_per_1k.updates"] == pytest.approx(20.0 / 4)
