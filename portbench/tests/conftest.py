"""Shared fixtures of the benchmark's own tests: a small version of each
cell that runs on the CPU in about a second."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a few thousand points, small batches: the code paths of a full cell
SMALL = {
    "config": {"initial_state": {"bulk_load": 1500, "stream": 1500, "stream_batch": 500},
               "index": {"delta_capacity": 256}},
    "traffic": {"batch": 128, "update_batch": 100, "query_batch": 16, "queries_every": 1,
                "rate_per_s": 40.0, "slice_s": 0.5},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where there is none)")


@pytest.fixture
def small_run():
    """run(cell, seed, **kw): one small run of `cell` on the CPU; returns
    the result line as a dict. The environment and the path the harness
    sets are restored afterwards."""
    import time

    import torch

    from portbench import catalog, harness

    environ, path = dict(os.environ), list(sys.path)
    harness.prepare_env(ROOT)

    def run(cell, seed=987654321012, seconds=0.5, trace=False, **kw):
        c = catalog.cell(cell, overrides=SMALL)
        return harness.run(c, seed, seconds, trace, time.perf_counter(),
                           torch.device("cpu"), wait_s=kw.pop("wait_s", 2.0), **kw)
    yield run
    os.environ.clear()
    os.environ.update(environ)
    sys.path[:] = path
