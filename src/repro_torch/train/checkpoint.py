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

On a mesh (DTensor leaves) `save` gathers each array once on every rank
and rank 0 alone writes; every rank waits for the write. `restore`
re-places each array on the current mesh as its template (or
`shardings`) places it: a checkpoint written on any mesh restores on any
other, the reference's elastic path.
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
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


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
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _writer() -> bool:
    """True where this process writes: rank 0 of a group, or alone."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def save(ckpt_dir, step: int, state: Dict[str, Any], keep_last: int = 3,
         extra: Optional[dict] = None) -> pathlib.Path:
    """state: {part name: tree}, e.g. {"params": ..., "opt": ...}."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    arrays = {name: {k: _host(v) for k, v in _leaves(tree)}
              for name, tree in state.items()}
    if not _writer():
        _barrier()
        return final
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=ckpt_dir))
    try:
        for name, host in arrays.items():
            np.savez(tmp / f"{name}.npz", **host)
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
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _retain(ckpt_dir, keep_last)
    _barrier()
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


def _rebuild(tree, data, path="", like=None):
    if isinstance(tree, dict):
        return {k: _rebuild(v, data, f"{path}[{k!r}]",
                            None if like is None else like[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, data, f"{path}[{i}]",
                                   None if like is None else like[i])
                          for i, v in enumerate(tree))
    arr = data[path]
    like = tree if like is None else like
    if isinstance(like, DTensor):
        full = torch.from_numpy(np.array(arr)).to(device=like.to_local().device,
                                                  dtype=tree.dtype)
        return distribute_tensor(full, like.device_mesh, like.placements,
                                 src_data_rank=None)
    if isinstance(tree, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=tree.device,
                                                  dtype=tree.dtype)
    return arr


def restore(path, templates: Dict[str, Any],
            shardings: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Restore the parts named in `templates` (trees defining structure):
    each leaf read by its keystr path; a tensor leaf gives a tensor of its
    dtype on its device, a DTensor leaf a DTensor placed as it is (each
    rank reads the whole array and keeps its shard), any other leaf the
    stored array. `shardings` (trees of the templates' structure whose
    leaves are DTensors, by part name) places the restored arrays as its
    leaves are placed instead: the reference's argument."""
    path = pathlib.Path(path)
    out = {}
    for name, template in templates.items():
        with np.load(path / f"{name}.npz") as data:
            out[name] = _rebuild(template, data, "",
                                 (shardings or {}).get(name))
    return out


def manifest(path) -> dict:
    return json.loads((pathlib.Path(path) / "manifest.json").read_text())
