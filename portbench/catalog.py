"""Find a cell's configuration, traffic mix, parameters and metric
readers by the names `BENCHMARK.json` gives them.

    configs/<config>.json     the deployment: data, index, durability,
                              the state set-up builds (`file` in
                              BENCHMARK.json names it)
    traffic/<traffic>.json    the traffic mix: one general driver
                              (`traffic.py`) reads its `mode` and
                              parameters
    workloads/<cell>.json     what belongs to the one cell: parameters
                              laid over its traffic mix (a fixed rate)
                              and the limits of its comparison
    metrics/<metric>.py       one reader per metric, end-to-end and
                              per-layer alike: `read(ctx)` returns the
                              number, or None where it finds nothing

A later cell or metric is added by adding files and entries; nothing
here names one.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def reader(name: str):
    """The `read(ctx)` function of metric `name` (metrics/<name>.py)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _overlay(base: dict, over: dict) -> dict:
    out = dict(base)
    for key, val in over.items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = _overlay(out[key], val)
        else:
            out[key] = val
    return out


class Cell:
    """One entry of `workloads` with everything found for it."""

    def __init__(self, bench: dict, name: str, root: pathlib.Path = ROOT,
                 overrides: dict | None = None):
        entry = _by_name(bench["workloads"], name, "workload")
        conf = _by_name(bench["configs"], entry["config"], "config")
        over = overrides or {}
        self.name = name
        self.chips = int(entry["chips"])
        self.config = _overlay(_json(root / conf["file"]), over.get("config", {}))
        cell = _json(HERE / "workloads" / f"{name}.json")
        traffic = _json(HERE / "traffic" / f"{entry['traffic']}.json")
        self.traffic = _overlay(_overlay(traffic, cell.get("traffic", {})),
                                over.get("traffic", {}))
        self.limits = cell["limits"]
        self.check = _overlay(cell.get("check", {}), over.get("check", {}))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]


def cell(name: str, root: pathlib.Path = ROOT, overrides: dict | None = None) -> Cell:
    return Cell(benchmark(root), name, root, overrides)
