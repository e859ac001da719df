"""Fault-tolerant checkpointing (a port of the reference's
`train/checkpoint.py`), in the reference's file layout.

  * one directory per step, `<dir>/step_<n:08d>`, holding `<part>.npz`
    for each part of the state ("params", "opt") and `manifest.json`
    ({"step", "time", "parts", ...extra});
  * writes are ATOMIC: serialize to `<dir>/.tmp-<step>-*`, fsync every
    file, then rename; a crash mid-write never corrupts the latest
    checkpoint;
  * retention: keep_last N, delete older; `latest` finds the newest
    complete step.

A part is a tree of nested dicts and lists whose leaves are tensors or
arrays. Its npz keys are the reference's `jax.tree_util.keystr` paths
(`['groups'][0]['b0']['mixer']['wq']`, `['m']['embed']`, `['step']`),
so the two packages restore each other's checkpoints: the port writes
its model and moments in the reference's tree (`convert.reference_tree`).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _leaves(tree, path=""):
    """(keystr path, leaf) of a nested dict / list tree, in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir, step: int, state: Dict[str, Any], keep_last: int = 3,
         extra: Optional[dict] = None) -> pathlib.Path:
    """state: {part name: tree}, e.g. {"params": ..., "opt": ...}."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=ckpt_dir))
    try:
        for name, tree in state.items():
            np.savez(tmp / f"{name}.npz",
                     **{k: _host(v) for k, v in _leaves(tree)})
        manifest = {
            "step": step,
            "time": time.time(),
            "parts": sorted(state.keys()),
            **(extra or {}),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        for f in tmp.iterdir():  # fsync before rename for crash safety
            with open(f, "rb") as fh:
                os.fsync(fh.fileno())
        final = ckpt_dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _retain(ckpt_dir, keep_last)
    return final


def _retain(ckpt_dir: pathlib.Path, keep_last: int):
    steps = sorted(ckpt_dir.glob("step_*"))
    for old in steps[:-keep_last]:
        shutil.rmtree(old, ignore_errors=True)


def latest(ckpt_dir) -> Optional[pathlib.Path]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [p for p in sorted(ckpt_dir.glob("step_*"))
             if (p / "manifest.json").exists()]
    return steps[-1] if steps else None


def _rebuild(tree, data, path=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, data, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, data, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    arr = data[path]
    if isinstance(tree, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=tree.device,
                                                  dtype=tree.dtype)
    return arr


def restore(path, templates: Dict[str, Any]) -> Dict[str, Any]:
    """Restore the parts named in `templates` (trees defining structure):
    each leaf read by its keystr path; a tensor leaf gives a tensor of its
    dtype on its device, any other leaf the stored array. The reference's
    `shardings` argument has no counterpart on one device."""
    path = pathlib.Path(path)
    out = {}
    for name, template in templates.items():
        with np.load(path / f"{name}.npz") as data:
            out[name] = _rebuild(template, data)
    return out


def manifest(path) -> dict:
    return json.loads((pathlib.Path(path) / "manifest.json").read_text())
