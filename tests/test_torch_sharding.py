"""The port's logical-axis rules (`repro_torch.models.sharding`) against
the reference's, on stand-in meshes that carry only what `Rules` reads
(no process group):

  * `Rules.resolve` equals the reference's `Rules.resolve` for every
    parameter of every published config (its `abstract_params`, a scan
    group's leading layer axis dropped), under train and serve rules, on
    the 16 x 16 and the 2 x 16 x 16 production meshes;
  * the parameter elements one device holds equal the reference's
    placement of qwen2-0.5b and deepseek-v2-lite-16b on both meshes;
  * `placements` of a dim mapped to ("pod", "data") gives each (pod,
    data) index the block JAX's `P(("pod", "data"))` gives it: pod major,
    data minor.
"""
import functools
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import model as ref_model
from repro.models import sharding as ref_sharding
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models import sharding

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULES = ("train", "serve")
# the reference's placement, per device (its Rules.resolve on the
# stand-in mesh; parameters from abstract_params, all f32): the pod axis
# carries only the batch, so both meshes give the same shard
PER_DEVICE = {("qwen2-0.5b", "train"): 1_975_168,
              ("qwen2-0.5b", "serve"): 30_918_208,
              ("deepseek-v2-lite-16b", "train"): 65_081_344,
              ("deepseek-v2-lite-16b", "serve"): 988_286_464}


def _ref_rules(kind, mesh):
    shape, names = MESHES[mesh]
    stand_in = SimpleNamespace(axis_names=names, devices=np.empty(shape))
    return getattr(ref_sharding, f"{kind}_rules")(stand_in)


def _port_rules(kind, mesh):
    shape, names = MESHES[mesh]
    stand_in = SimpleNamespace(mesh_dim_names=names, shape=shape)
    return getattr(sharding, f"{kind}_rules")(stand_in)


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch):
    """[(port parameter name, reference shape, reference spec)] of every
    reference leaf, each layer of a stacked scan group once, its leading
    layer axis dropped."""
    cfg = ref_configs.get(arch)
    values, specs = ref_model.abstract_params(cfg)
    flat_v = jax.tree_util.tree_flatten_with_path(values)[0]
    flat_s = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, tuple))
    first = []  # the first port layer index of each scan group
    n = 0
    for unit, reps in cfg.scan_groups():
        first.append((n, len(unit), reps))
        n += len(unit) * reps
    out = []
    for (path, v), spec in zip(flat_v, flat_s):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        shape = tuple(v.shape)
        if keys[0] != "groups":
            out.append((".".join(keys), shape, tuple(spec)))
            continue
        start, width, reps = first[keys[1]]
        unit_i = int(keys[2][1:])
        if reps > 1:
            shape, spec = shape[1:], tuple(spec)[1:]
        for r in range(reps):
            name = ".".join(["layers", str(start + r * width + unit_i), *keys[3:]])
            out.append((name, shape, tuple(spec)))
    return out


@functools.lru_cache(maxsize=None)
def _port_layout(arch):
    cfg = configs.get(arch)
    return sharding.param_layout(cfg, M.Model(cfg, device="meta"))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kind", RULES)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_resolve_equals_reference(arch, kind, mesh):
    ref_rules, rules = _ref_rules(kind, mesh), _port_rules(kind, mesh)
    layout = _port_layout(arch)
    leaves = _ref_leaves(arch)
    assert sorted(n for n, _, _ in leaves) == sorted(layout)
    for name, shape, spec in leaves:
        port_shape, port_spec = layout[name]
        assert port_shape == shape and port_spec == spec, name
        assert rules.resolve(shape, spec) == tuple(ref_rules.resolve(shape, spec)), name


def _per_device(rules, layout) -> int:
    total = 0
    for shape, spec in layout.values():
        shards = 1
        for axes in rules.resolve(shape, spec):
            for a in ((axes,) if isinstance(axes, str) else axes or ()):
                shards *= rules.sizes[a]
        total += math.prod(shape) // shards
    return total


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,kind", sorted(PER_DEVICE))
def test_per_device_elements_equal_reference(arch, kind, mesh):
    rules = _port_rules(kind, mesh)
    assert _per_device(rules, _port_layout(arch)) == PER_DEVICE[(arch, kind)]
    ref_rules = _ref_rules(kind, mesh)
    ref_total = sum(math.prod(s) // math.prod(
        ref_rules.sizes[a] for axes in ref_rules.resolve(s, spec) if axes
        for a in ((axes,) if isinstance(axes, str) else axes))
        for _, s, spec in _ref_leaves(arch))
    assert ref_total == PER_DEVICE[(arch, kind)]


def test_pod_data_placement_is_pod_major():
    """A (64, 8) batch on the 2 x 16 x 16 mesh: each (pod, data, model)
    index holds rows [2·(16·pod + data), +2), as JAX's P(("pod", "data"))
    lays a dim over the two axes, major to minor."""
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    rules = _port_rules("train", "2x16x16")
    pl = rules.placements((64, 8), ("batch", None))
    assert rules.resolve((64, 8), ("batch", None)) == (("pod", "data"), None)
    for pod in range(2):
        for data in range(16):
            for model in (0, 7):
                shape, offset = _compute_local_shape_and_global_offset(
                    (64, 8), (2, 16, 16), [pod, data, model], pl)
                assert tuple(shape) == (2, 8)
                assert tuple(offset) == (2 * (16 * pod + data), 0)


def test_constrain_is_identity_off_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert sharding.constrain(x, "batch", None) is x
    with sharding.axis_rules(_port_rules("train", "16x16")):
        assert sharding.current_rules() is not None
        assert sharding.constrain(x, "batch", None) is x
    assert sharding.current_rules() is None
