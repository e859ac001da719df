"""The benchmark's command, one short run of a cell on a card (skips without one)."""
import json
import subprocess
import sys

import pytest

from portbench import catalog

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's runs need a card")


def test_one_short_run_is_correct(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "hl2d-bulk", "--seed",
         "3000000017", "--seconds", "3", "--trace", "0"],
        cwd=catalog.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "compared"
