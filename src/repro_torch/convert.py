"""Carry tree state across from the reference package.

`tree_from_reference` takes a `Tree` built by either package (its fields
numpy arrays — both builders return numpy) and returns the port's own
`Tree`, so tests can run the reference and the port on the SAME tree
and compare paper-metric counts exactly. No import of the reference is
needed: the fields are read by name. `sharded_index_from_reference`
does the same for the reference's `distributed.ShardedIndex`, and
`model_from_reference` for the reference's model parameters.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .core import distributed as _distributed
from .core import search as _search
from .core.types import Tree, TreeSpec

_ARRAY_FIELDS = (
    "center", "radius", "child_l", "child_r", "start", "count", "points",
    "perm", "leaf_of_node", "leaf_points", "leaf_index",
)


def tree_from_reference(tree) -> Tree:
    """The port's `Tree` holding copies of `tree`'s numpy fields."""
    spec = getattr(tree, "spec", None)
    if spec is not None:
        spec = TreeSpec(**{
            f.name: getattr(spec, f.name) for f in dataclasses.fields(TreeSpec)
        })
    return Tree(
        **{f: np.array(getattr(tree, f)) for f in _ARRAY_FIELDS}, spec=spec
    )


def device_tree(tree, device="cuda", dtype=None) -> _search.DeviceTree:
    """Upload a tree of either package as the port's `DeviceTree`."""
    import torch

    return _search.device_tree(
        tree_from_reference(tree), dtype or torch.float32, device
    )


def sharded_index_from_reference(index, device="cuda") -> _distributed.ShardedIndex:
    """The port's `ShardedIndex` over the reference's per-shard host trees
    and shard offsets, every shard on `device` (a device, or a list of
    them for round-robin placement)."""
    devs = _distributed.device_list(device)
    trees = [tree_from_reference(t) for t in index.trees]
    return _distributed.from_trees(
        trees,
        np.asarray(index.shard_offsets, np.int64),
        [devs[s % len(devs)] for s in range(len(trees))],
    )


def _layer_values(cfg, groups):
    """The reference's per-group value trees as one tree per layer, in
    layer order: a group of `reps` > 1 holds its unit's leaves stacked on
    a leading axis, which is taken apart here."""
    out = []
    for (unit, reps), group in zip(cfg.scan_groups(), groups):
        for r in range(reps):
            for i in range(len(unit)):
                block = group[f"b{i}"]
                if reps > 1:
                    block = _take(block, r)
                out.append(block)
    return out


def _take(tree, r):
    if isinstance(tree, dict):
        return {k: _take(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def model_from_reference(cfg, values, device="cuda"):
    """The port's model of `cfg` (a port `ModelConfig`) holding the
    numbers of the reference's value tree `values` (the first half of
    `split_params(init_params(...))`, numpy or device arrays), on
    `device` ("cuda" unless the caller asks for the CPU; no card raises).
    Leaves are matched by name, the scan groups' stacked layers taken
    apart (`_layer_values`). The reference's f32 weights of bf16 products
    are stored rounded to bf16, as the reference rounds them at every use;
    the weights it uses in f32 arithmetic stay f32, unrounded: norms, the
    MoE router, MLA's w_uv (which the absorbed decode uses unrounded), the
    RG-LRU's conv_w, conv_b, w_r, w_i, b_r, b_i and lam, the mLSTM's w_i,
    w_f, b_i, b_f and norm, and the sLSTM's w_g, r_g and b_g of its four
    gates. Merged head axes: wq (d, H, hd) -> (d, H·hd), wo (H, hd, d) ->
    (H·hd, d), biases (H, hd) -> (H·hd,), and MLA's the same way; the
    block-diagonal and recurrent (nh, dh, dh) weights keep their shape."""
    import torch

    from .models import model as M

    dev = M.resolve_device(device)
    model = M.Model(cfg, device=dev)

    layers = _layer_values(cfg, values["groups"])
    if len(layers) != len(model.layers):
        raise ValueError(f"{len(layers)} reference layers, {len(model.layers)} "
                         f"in the port's {cfg.name}")
    with torch.no_grad():
        for block, ref in zip(model.layers, layers):
            _load(block, ref)
        _put(model.final_norm, values["final_norm"])
        for name in ("embed", "unembed"):
            if hasattr(model, name):
                _put(getattr(model, name), values[name])
    return model


def _put(param, value):
    """Copy a numpy (or device) array into `param`, reshaped and cast to
    its shape and type."""
    import torch

    v = torch.from_numpy(np.asarray(value, np.float32).copy())
    param.data.copy_(v.reshape(param.shape).to(param.dtype))


def _load(module, tree):
    """Copy the nested value tree `tree` into `module`'s parameters, each
    found by its dotted name ("ffn.shared.w_up" -> tree["ffn"]["shared"]
    ["w_up"])."""
    for name, param in module.named_parameters():
        leaf = tree
        for key in name.split("."):
            leaf = leaf[key]
        _put(param, leaf)
