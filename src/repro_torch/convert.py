"""Carry tree state across from the reference package.

`tree_from_reference` takes a `Tree` built by either package (its fields
numpy arrays — both builders return numpy) and returns the port's own
`Tree`, so tests can run the reference and the port on the SAME tree
and compare paper-metric counts exactly. No import of the reference is
needed: the fields are read by name. `sharded_index_from_reference`
does the same for the reference's `distributed.ShardedIndex`, and
`model_from_reference` for the reference's model parameters.
`reference_tree` is the inverse: the port's parameters (or AdamW
moments, which carry the same names) as the reference's value tree, which
is what the training checkpoints store; `load_reference_tree` copies such
a tree back into them, and `reference_ndims` gives each leaf's rank.
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
    return tree[r]


def _reference_shapes(cfg, mixer: str) -> dict:
    """The reference's shapes of the weights whose head axes the port
    merges (every other weight has the same shape in both)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    if mixer == "attn":
        return {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
                "wo": (h, hd, d), "bq": (h, hd), "bk": (kv, hd), "bv": (kv, hd)}
    if mixer == "mla":
        qn, qr, vh = cfg.qk_nope, cfg.qk_rope, cfg.v_head
        return {"w_uk": (cfg.kv_lora, h, qn), "w_uv": (cfg.kv_lora, h, vh),
                "w_q": (d, h, qn + qr), "w_o": (h, vh, d)}
    return {}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    import torch

    if isinstance(trees[0], torch.Tensor):
        return torch.stack(trees)
    return np.stack(trees)


def reference_tree(cfg, named) -> dict:
    """The reference's value tree of `named`, {port parameter name: tensor}
    (a model's `named_parameters()`, or AdamW moments of the same names):
    {"groups": [...], "final_norm", "embed" / "unembed"}, each layer's
    leaves under its scan group's `b<i>` keys with the reference's shapes,
    a group of `reps` > 1 stacked on a leading axis (the inverse of
    `_layer_values`). Leaves are reshaped views or stacked copies of the
    given tensors."""
    plan = cfg.layer_plan()
    layers = [{} for _ in plan]
    tree = {}
    for name, t in named.items():
        if not name.startswith("layers."):
            tree[name] = t
            continue
        _, idx, rest = name.split(".", 2)
        keys = rest.split(".")
        shape = None
        if keys[0] == "mixer" and len(keys) == 2:
            shape = _reference_shapes(cfg, plan[int(idx)][0]).get(keys[1])
        node = layers[int(idx)]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t.reshape(shape) if shape else t
    it = iter(layers)
    groups = []
    for unit, reps in cfg.scan_groups():
        units = [{f"b{i}": next(it) for i in range(len(unit))}
                 for _ in range(reps)]
        groups.append(units[0] if reps == 1 else _stack(units))
    return {"groups": groups, **tree}


def reference_ndims(cfg, named) -> dict:
    """{port parameter name: its number of dims as a leaf of the
    reference's value tree (`reference_tree`)} for the names of `named`:
    the head axes the port merges split again, and one more in a scan
    group of `reps` > 1, whose leaves are stacked on a leading axis. The
    reference's AdamW decays a leaf of 2 dims or more, so this is what
    decides the port's decay (`train.optimizer.update`), on one card and
    on a mesh alike."""
    plan = cfg.layer_plan()
    stacked = [reps > 1 for unit, reps in cfg.scan_groups()
               for _ in range(reps) for _ in unit]
    out = {}
    for name, t in named.items():
        if not name.startswith("layers."):
            out[name] = t.ndim
            continue
        _, idx, rest = name.split(".", 2)
        keys = rest.split(".")
        shape = None
        if keys[0] == "mixer" and len(keys) == 2:
            shape = _reference_shapes(cfg, plan[int(idx)][0]).get(keys[1])
        out[name] = (len(shape) if shape else t.ndim) + stacked[int(idx)]
    return out


def load_reference_tree(cfg, named, tree) -> None:
    """Copy the reference's value tree `tree` (numpy, JAX or torch leaves)
    into the tensors of `named` ({port parameter name: tensor}), each
    leaf found by the name's path and reshaped and cast to its tensor."""
    layers = _layer_values(cfg, tree["groups"])
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} reference layers, {cfg.n_layers} "
                         f"in the port's {cfg.name}")
    _load(named, {**tree, "layers": {str(i): v for i, v in enumerate(layers)}})


def model_from_reference(cfg, values, device="cuda", param_dtype=None):
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
    block-diagonal and recurrent (nh, dh, dh) weights keep their shape.
    With `param_dtype=torch.float32` every weight is kept f32, unrounded:
    the f32 masters of training (`models.model.Model`)."""
    from .models import model as M

    dev = M.resolve_device(device)
    model = M.Model(cfg, device=dev, param_dtype=param_dtype or M.COMPUTE_DTYPE)
    load_reference_tree(cfg, dict(model.named_parameters()), values)
    return model


def _put(param, value):
    """Copy a numpy, JAX or torch array into `param`, reshaped and cast to
    its shape and type."""
    import torch

    if isinstance(value, torch.Tensor):
        v = value.detach()
    else:
        v = torch.from_numpy(np.asarray(value, np.float32).copy())
    param.data.copy_(v.reshape(param.shape).to(param.dtype))


def _leaf(tree, name: str):
    """The leaf of the nested tree at a dotted name ("ffn.shared.w_up" ->
    tree["ffn"]["shared"]["w_up"])."""
    for key in name.split("."):
        tree = tree[key]
    return tree


def _load(params, tree):
    """Copy the nested value tree `tree` into `params` (a module's
    parameters, or {dotted name: tensor}), each found by its dotted name."""
    import torch

    named = params.items() if isinstance(params, dict) else params.named_parameters()
    with torch.no_grad():
        for name, param in named:
            _put(param, _leaf(tree, name))
