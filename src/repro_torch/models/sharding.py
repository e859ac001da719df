"""Logical-axis sharding rules on `torch.distributed` (a port of the
reference's `models/sharding.py`), and what the port needs to run a model
on a `DeviceMesh`.

Parameters and activations are annotated with *logical* axis names; a
`Rules` object built from the mesh maps them to mesh axes. Resolution is
shape-aware, line for line the reference's: a logical axis is dropped
(replicated) for a dim that the mapped mesh-axis product does not divide,
or whose mesh axes an earlier dim of the same array already uses.

Train rules:  batch=(pod,data)  fsdp=(data)  tp/seq/exp/heads/hd/vocab=(model)
Serve rules:  the same but fsdp=() — parameters are TP-sharded and
              replicated across the data axis.

`resolve` returns the reference's `PartitionSpec` content as a tuple (an
axis name, a tuple of names, or None per dim); `placements` turns it into
DTensor placements: `Shard(d)` on every mesh dim the rules map to tensor
dim d, else `Replicate()`. A dim mapped to several mesh axes is sharded
over them major to minor in mesh order, which is JAX's
`P(("pod", "data"))`.

On a mesh a model's parameters are DTensors placed by the rules on the
reference's shapes (`shard_model`; weights the port stores with merged
head axes are placed as the reference's (d, H, hd) arrays). `constrain`
is `redistribute`. Every product with a weight goes through `einsum`,
which fixes the collectives as the reference's rules intend them: the
weight's data (FSDP) shard is gathered for use and its gradient
reduce-scattered; on the model axis the weight stays sharded and an
activation sharded there on another dim is gathered or exchanged
(Megatron's sequence parallelism); a contraction sharded on both sides
gives partial sums, all-reduced in f32 before the one rounding to bf16.
Regions that run on local shards with no collective (the attention walk,
the recurrences, the MoE dispatch) go through `region`, a `local_map`
whose placements are the reference's constraints.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

LogicalSpec = Tuple[Optional[str], ...]

# the rules in force: one for the process, not a thread's (the reference
# keeps them thread-local), because autograd runs the backward of CUDA
# tensors, and the recomputed forward of `torch.utils.checkpoint` in it,
# on threads of its own
_RULES: list = [None]


class Rules:
    """`mapping` (logical name -> mesh axes) over `mesh`, of which only
    the dim names (`mesh_dim_names`) and sizes (`shape`) are read."""

    def __init__(self, mapping: Dict[str, Tuple[str, ...]], mesh):
        self.mapping = mapping
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = dict(zip(self.names, tuple(mesh.shape)))

    def physical(self, name: Optional[str]) -> Tuple[str, ...]:
        if name is None:
            return ()
        return tuple(a for a in self.mapping.get(name, ()) if a in self.sizes)

    def resolve(self, shape: Sequence[int], spec: LogicalSpec) -> tuple:
        assert len(spec) == len(shape), (spec, shape)
        used = set()
        out = []
        for dim, name in zip(shape, spec):
            phys = self.physical(name)
            prod = 1
            for a in phys:
                prod *= self.sizes[a]
            if (
                phys
                and not (set(phys) & used)
                and prod > 1
                and dim % prod == 0
            ):
                used.update(phys)
                out.append(phys if len(phys) > 1 else phys[0])
            else:
                out.append(None)
        return tuple(out)

    def placements(self, shape: Sequence[int], spec: LogicalSpec) -> list:
        """The DTensor placements of `resolve(shape, spec)`, one a mesh dim."""
        out = [Replicate() for _ in self.names]
        for d, axes in enumerate(self.resolve(shape, spec)):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else axes
            idx = [self.names.index(a) for a in axes]
            assert idx == sorted(idx), (axes, self.names)  # major to minor
            for i in idx:
                out[i] = Shard(d)
        return out


def train_rules(mesh) -> Rules:
    return Rules(
        {
            "batch": ("pod", "data"),
            "fsdp": ("data",),
            "tp": ("model",),
            "seq": ("model",),
            "exp": ("model",),
            "heads": ("model",),
            "hd": ("model",),
            "vocab": ("model",),
        },
        mesh,
    )


def serve_rules(mesh) -> Rules:
    r = train_rules(mesh)
    r.mapping = dict(r.mapping, fsdp=())
    return r


# --------------------------------------------------------------------- #
# run-time context: `constrain` is the identity outside `axis_rules(...)`
# and on plain tensors, so the one-card path runs unchanged.
@contextlib.contextmanager
def axis_rules(rules: Optional[Rules]):
    prev = _RULES[0]
    _RULES[0] = rules
    try:
        yield
    finally:
        _RULES[0] = prev


def current_rules() -> Optional[Rules]:
    return _RULES[0]


def on_mesh(x) -> bool:
    return isinstance(x, DTensor)


def constrain(x, *spec: Optional[str]):
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, rules.placements(x.shape, tuple(spec)))


def place(x: torch.Tensor, rules: Rules, spec: LogicalSpec) -> DTensor:
    """`x` (the same full tensor on every rank, or a meta tensor) as a
    DTensor placed by `rules`: each rank keeps its own shard, nothing is
    sent."""
    return distribute_tensor(x, rules.mesh, rules.placements(x.shape, spec),
                             src_data_rank=None)


# --------------------------------------------------------------------- #
# the reference's logical specs of every parameter, by the port's names
def _mixer_specs(cfg, mixer: str) -> Dict[str, LogicalSpec]:
    hds = "hd" if cfg.shard_hd else None
    if mixer == "attn":
        return {"wq": ("fsdp", "heads", hds), "wk": ("fsdp", "heads", hds),
                "wv": ("fsdp", "heads", hds), "wo": ("heads", hds, "fsdp"),
                "bq": ("heads", hds), "bk": ("heads", hds), "bv": ("heads", hds)}
    if mixer == "mla":
        return {"w_dkv": ("fsdp", "tp"), "norm_kv": (None,),
                "w_uk": ("fsdp", "heads", hds), "w_uv": ("fsdp", "heads", hds),
                "w_kr": ("fsdp", None), "w_q": ("fsdp", "heads", hds),
                "w_o": ("heads", hds, "fsdp")}
    if mixer == "rglru":
        return {"w_x": ("fsdp", "tp"), "w_gate": ("fsdp", "tp"),
                "conv_w": (None, "tp"), "conv_b": ("tp",),
                "w_r": ("heads", None, None), "w_i": ("heads", None, None),
                "b_r": (None,), "b_i": (None,), "lam": (None,),
                "w_out": ("tp", "fsdp")}
    if mixer == "mlstm":
        return {"w_up": ("fsdp", "tp"), "wq": ("tp", None), "wk": ("tp", None),
                "wv": ("tp", None), "w_i": ("tp", None), "w_f": ("tp", None),
                "b_i": (None,), "b_f": (None,), "norm": (None,),
                "w_down": ("tp", "fsdp")}
    if mixer == "slstm":
        out = {"w_ffn1": ("fsdp", "tp"), "w_ffn2": ("tp", "fsdp")}
        for g in ("z", "i", "f", "o"):
            out.update({f"w_{g}": ("fsdp", "tp"), f"r_{g}": (None, None, None),
                        f"b_{g}": (None,)})
        return out
    raise KeyError(mixer)


_MLP = {"w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"), "w_down": ("tp", "fsdp")}
_MOE = {"router": (None, None), "w_gate": ("exp", "fsdp", None),
        "w_up": ("exp", "fsdp", None), "w_down": ("exp", None, "fsdp")}
_TOP = {"embed": ("vocab", "fsdp"), "unembed": ("fsdp", "vocab"),
        "final_norm": (None,)}


_CACHE = {
    "attn": {"k": ("batch", "seq", "heads", "hd"), "v": ("batch", "seq", "heads", "hd")},
    "mla": {"ckv": ("batch", "seq", None), "kr": ("batch", "seq", None)},
    "rglru": {"h": ("batch", "tp"), "conv": ("batch", None, "tp")},
    "mlstm": {"C": ("batch", "heads", None, None), "n": ("batch", "heads", None)},
    "slstm": {k: ("batch", "tp") for k in ("c", "n", "h", "m")},
}


def cache_spec(cfg, layer: int, name: str) -> LogicalSpec:
    """The reference's logical spec of layer `layer`'s decode cache entry
    `name` (its mixer's `*_cache_shape`)."""
    return _CACHE[cfg.layer_plan()[layer][0]][name]


def param_spec(cfg, name: str) -> LogicalSpec:
    """The reference's logical spec of the port's parameter `name`
    ("layers.3.mixer.wq"), without a scan group's leading layer axis."""
    if not name.startswith("layers."):
        return _TOP[name]
    _, idx, rest = name.split(".", 2)
    keys = rest.split(".")
    mixer, ffn = cfg.layer_plan()[int(idx)]
    if keys[0] in ("norm1", "norm2"):
        return (None,)
    if keys[0] == "mixer":
        return _mixer_specs(cfg, mixer)[keys[1]]
    if ffn == "moe" and keys[1] != "shared":
        return _MOE[keys[1]]
    return _MLP[keys[-1]]


def reference_shape(cfg, name: str, shape) -> Tuple[int, ...]:
    """The reference's shape of the port's parameter `name` of `shape`
    (the head axes the port merges, split again)."""
    from ..convert import _reference_shapes

    if name.startswith("layers."):
        _, idx, rest = name.split(".", 2)
        keys = rest.split(".")
        if keys[0] == "mixer" and len(keys) == 2:
            mixer = cfg.layer_plan()[int(idx)][0]
            ref = _reference_shapes(cfg, mixer).get(keys[1])
            if ref is not None:
                return tuple(ref)
    return tuple(shape)


def param_layout(cfg, model: nn.Module) -> Dict[str, Tuple[tuple, LogicalSpec]]:
    """{name: (reference shape, logical spec)} of every parameter."""
    return {n: (reference_shape(cfg, n, p.shape), param_spec(cfg, n))
            for n, p in model.named_parameters()}


def shard_model(model: nn.Module, rules: Rules) -> nn.Module:
    """Replace every parameter of `model` by a DTensor placed by `rules`
    on the reference's shape (`param_layout`), in place; returns the
    model. The model code uses a weight so stored through its
    reference-shaped products (`einsum`)."""
    cfg = model.cfg
    for name, (shape, spec) in param_layout(cfg, model).items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        p = getattr(mod, leaf)
        dt = place(p.detach().reshape(shape), rules, spec)
        setattr(mod, leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
    return model


def per_device_elements(model: nn.Module) -> int:
    """The parameter elements one device holds (rank 0's shards)."""
    return int(sum(p.to_local().numel() if isinstance(p, DTensor) else p.numel()
                   for p in model.parameters()))


# --------------------------------------------------------------------- #
# products with a weight, and local regions
def _no_partial(x: DTensor) -> DTensor:
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in x.placements])
    return x


def _letter(pl, letters: str) -> Optional[str]:
    return letters[pl.dim] if pl.is_shard() else None


def einsum(eq: str, x: DTensor, w: DTensor, f32: bool = False) -> DTensor:
    """`eq` ("bsd,dhk->bshk") of an activation x and a weight w, both
    DTensors on one mesh, in the compute type: bf16 operands, f32 sums,
    one rounding to bf16, as `layers.matmul` (with `f32`: the operands'
    own values in f32, an f32 result). Decided mesh dim by mesh dim (see
    the module docstring); returns a DTensor with no partial placement."""
    from .layers import COMPUTE_DTYPE

    mesh = w.device_mesh
    ins, out = eq.split("->")
    lx, lw = ins.split(",")
    x = _no_partial(x)
    xp, wp = list(x.placements), list(w.placements)
    names = mesh.mesh_dim_names
    x_g, w_g, o_p = [], [], []
    partial = False
    for m in range(mesh.ndim):
        a, b = _letter(xp[m], lx), _letter(wp[m], lw)
        model_axis = names[m] == "model"
        if b is not None and b not in lx and a is not None:
            # the weight shards one of its own output dims, the activation
            # another dim: gather the activation on the model axis
            # (sequence parallelism), the weight elsewhere (FSDP)
            if model_axis:
                xp[m], a = Replicate(), None
            else:
                wp[m], b = Replicate(), None
        if b is not None and b in lx and a != b:
            # a dim both have (contracted or batched): cut x there where it
            # is whole, exchange it on the model axis, else gather w
            if a is None or model_axis:
                xp[m], a = Shard(lx.index(b)), b
            else:
                wp[m], b = Replicate(), None
        if a is not None and a in lw and b is None:
            wp[m], b = Shard(lw.index(a)), a      # cut w where x is cut
        if a is not None and a == b:
            x_g.append(xp[m]), w_g.append(wp[m])
            if a in out:
                o_p.append(Shard(out.index(a)))
            else:
                o_p.append(Partial())
                partial = True
        elif a is not None:                       # x's own dim (batch, seq)
            x_g.append(xp[m]), w_g.append(Partial())
            o_p.append(Shard(out.index(a)))
        elif b is not None:                       # w's own output dim
            x_g.append(Partial()), w_g.append(wp[m])
            o_p.append(Shard(out.index(b)))
        else:
            x_g.append(Replicate()), w_g.append(Replicate())
            o_p.append(Replicate())
    x = x.redistribute(mesh, xp)
    w = w.redistribute(mesh, wp)

    def local(xl, wl):
        if f32:
            return torch.einsum(eq, xl.float(), wl.float())
        if partial:
            return torch.einsum(eq, xl.to(COMPUTE_DTYPE).float(),
                                wl.to(COMPUTE_DTYPE).float())
        return torch.einsum(eq, xl.to(COMPUTE_DTYPE), wl.to(COMPUTE_DTYPE))

    y = local_map(local, out_placements=o_p, in_placements=(xp, wp),
                  in_grad_placements=(x_g, w_g), device_mesh=mesh)(x, w)
    if partial:
        y = _no_partial(y)
        if not f32:
            y = y.to(COMPUTE_DTYPE)
    return y


def region(fn, args, in_placements, out_placements, grad_placements=None):
    """`fn` on the local shards of `args` (DTensors redistributed to
    `in_placements`; None for a non-tensor argument), its results wrapped
    as DTensors of `out_placements`. `grad_placements` gives an input's
    gradient placement where it is not its input placement (a weight
    used whole beside a batch shard has a partial gradient)."""
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    moved = tuple(a.redistribute(mesh, pl) if isinstance(a, DTensor) else a
                  for a, pl in zip(args, in_placements))
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=(tuple(grad_placements)
                                         if grad_placements else None),
                     device_mesh=mesh)(*moved)


def local(fn, x: DTensor) -> DTensor:
    """`fn` (a slice or view that leaves every sharded dim of `x` whole
    and in place) on each rank's shard of `x`: DTensor's own backward of
    such slices gathers the whole tensor, this one stays local."""
    pl = list(x.placements)
    return region(fn, (x,), (pl,), pl)


def split(x, sizes, dim: int = -1):
    """`x.split(sizes, dim)`; on a mesh each rank splits its rows with the
    split dim whole (gathered where it was sharded, as the reference's
    slices of a sharded dim are), so no backward gathers the rows."""
    if not isinstance(x, DTensor):
        return x.split(sizes, dim)
    d = dim % x.ndim
    pl = [Replicate() if p.is_partial() or (p.is_shard() and p.dim == d) else p
          for p in x.placements]
    return region(lambda t: tuple(t.split(sizes, d)), (x,), (pl,),
                  (pl,) * len(sizes))


def partial_where_batch(pl: list, batch_pl: list) -> list:
    """`pl` with Partial() on every mesh dim where `batch_pl` shards its
    first (batch) dim: the gradient placement of a weight used whole
    beside a batch shard."""
    return [Partial() if (b.is_shard() and b.dim == 0) else p
            for p, b in zip(pl, batch_pl)]


def coordinate(mesh, axis: str) -> int:
    """This rank's index along the mesh axis `axis` (0 without it)."""
    names = mesh.mesh_dim_names
    if axis not in names:
        return 0
    return int(mesh.get_coordinate()[names.index(axis)])


def replicated(t: torch.Tensor, like: DTensor) -> DTensor:
    """A tensor made inside the model (positions, tables, masks) as a
    replicated DTensor on `like`'s mesh."""
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def row_placements_of(pl: list) -> list:
    """`pl` with its first (batch) dim's shards alone: Replicate() on
    every mesh dim that does not shard dim 0."""
    return [p if (p.is_shard() and p.dim == 0) else Replicate() for p in pl]


def seq_reduce(t: torch.Tensor, op: str, mesh, dims) -> torch.Tensor:
    """Inside a region: `t` reduced (`op` "max" or "sum") across the
    mesh dims `dims` (those that shard a cache's time axis)."""
    import torch.distributed._functional_collectives as funcol

    for m in dims:
        t = funcol.all_reduce(t, op, (mesh, m))
        if hasattr(t, "wait"):
            t = t.wait()
    return t
