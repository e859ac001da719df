"""Production meshes (a port of the reference's `launch/mesh.py`), as
`torch.distributed.device_mesh.DeviceMesh`es over the current process
group.

Defined as FUNCTIONS, never module-level constants, so importing this
module touches no process group. A mesh needs a group of at least as
many ranks: `torchrun --nproc-per-node n` (or any launcher that sets up
`torch.distributed`) on real cards, or `fake_world(n)`, a fake group of
n ranks for rank 0 in which collectives are shape-only (the counterpart
of the reference's `--xla_force_host_platform_device_count`; the dry run
and the tests use it).

Topology as in the reference: one slice is 16 x 16 = 256 devices, meshed
as (data=16, model=16). Multi-pod adds a leading "pod" axis (2 x 16 x 16
= 512): the batch is sharded over (pod, data); parameters are
FSDP-sharded within a pod only.
"""
from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
          device_type: str) -> DeviceMesh:
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs a process group of {n} ranks but "
            f"{'none is initialised' if not have else f'it has {have}'}: "
            f"start {n} ranks with torchrun (--nproc-per-node {n}), or "
            f"enter launch.mesh.fake_world({n}) for a shape-only dry run")
    if have == n:
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) with `multi_pod`."""
    shape, names = PRODUCTION[multi_pod]
    return _mesh(shape, names, device_type)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the first data·model ranks (tests, the
    training launcher)."""
    return _mesh((data, model), ("data", "model"), device_type)


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of `n` ranks, this process rank 0, for the
    duration of the block: meshes over it build, and collectives on
    `meta` tensors give their shapes and move nothing. Raises inside a
    live group."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised in this process")
    # internal to torch; imported here only, so that nothing else of the
    # port depends on it
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()
