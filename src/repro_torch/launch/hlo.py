"""Work, traffic and memory of a call, counted from the aten ops it
dispatches (the port's counterpart of the reference's `launch/hlo.py`,
which reads the same quantities from compiled XLA HLO text; the module
keeps its name so that a reader finds it).

The port compiles no HLO: it runs eagerly, one aten op at a time. So
`analyze(fn, *args)` runs `fn` — on `meta` tensors, which allocate
nothing — under a `TorchDispatchMode` that sees every op the call
dispatches, the backward's included, and rolls up the reference's
`Cost` fields:

  flops            products (mm, bmm, addmm, baddbmm, ...):
                   2 · prod(result) · contraction (also `product_flops`);
                   one FLOP an element for the reference's ELEMENTWISE
                   set, by its aten names, and one an input element for
                   reductions
  hbm_bytes        operand bytes plus result bytes of every op that is
                   not a view: the eager program's real traffic, since the
                   port runs unfused
  collective_bytes operand bytes of every c10d collective, by the
                   reference's kinds (`COLLECTIVE_KINDS`): on a mesh, those
                   DTensor issues for its inputs and those the model's
                   regions issue; none on one card

On a mesh the counter lets DTensor dispatch each op (`NotImplemented`)
and counts what it runs on this rank: the local ops on the shards and
the collectives, so every figure is one device's (rank 0's).

A Python loop is counted as it runs, so no trip count is multiplied in:
the torch answer to the reference's while-loop problem (and the reason a
long time loop, the sLSTM's, is slow to count). `trace` also follows
the bytes of live tensors through the call (storages released by weak
references), the counterpart of `memory_analysis()`'s argument, output
and temporary sizes. `aten::bincount` has no meta kernel: on meta
tensors the counter gives it its `(minlength,)` result itself. Where a
dispatch mode makes autograd take a subclass's out-of-place branch
(`_IN_PLACE`), the counter takes the program's in-place one.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# the reference's ELEMENTWISE (XLA opcodes) by aten name, and the fused
# activations a torch program calls where XLA emits those opcodes
ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "exp", "log",
    "rsqrt", "sqrt", "tanh", "neg", "abs", "pow", "where", "eq", "ne", "lt",
    "le", "gt", "ge", "_to_copy", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "expm1", "log1p", "sign", "floor", "ceil", "cos", "sin",
    "sigmoid", "clamp", "clamp_min", "clamp_max", "reciprocal", "square",
    "gelu", "silu", "softplus", "erf", "exp2", "log2", "fmod", "remainder",
}
REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "norm", "linalg_vector_norm", "var", "std", "argmax", "argmin", "any",
    "all", "cumsum", "_softmax", "_log_softmax",
}
# ops whose result is not written (nothing moves)
_UNWRITTEN = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "lift_fresh"}
COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d")
# the reference's collective kinds (HLO opcodes) by the functional
# collectives that DTensor and the regions issue; the namespaces' other
# ops (wait_tensor, ...) move nothing
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}
# Autograd formulas keep an out-of-place branch for tensor subclasses
# (`areAnyTensorSubclassLike`, which holds whenever a dispatch mode is
# active): under the counter, gather's and index's backward would add
# their gradient into a second buffer beside the `new_zeros` they just
# made. Without a mode they write into those zeros in place, and so does
# the counter, so that its peak is the program's own. (The engine's own
# sum of two gradients of one tensor is out of place under a mode too,
# and is counted so: a transient the size of that gradient.)
_IN_PLACE = {aten.scatter_add.default: aten.scatter_add_.default,
             aten.index_put.default: aten.index_put_.default}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    product_flops: float = 0.0
    ops: int = 0
    # collective bytes by the process group they ran on (its name): which
    # mesh axis, and so which link, carried them
    collective_groups: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        self.product_flops += other.product_flops * mult
        self.ops += int(other.ops * mult)
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] = self.collective_bytes.get(k, 0.0) + v * mult
        for k, v in other.collective_groups.items():
            self.collective_groups[k] = self.collective_groups.get(k, 0.0) + v * mult

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())


def _name(func) -> str:
    """The op's aten name without its in-place mark: "add_" -> "add"."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") else name


_VIEWS: Dict[Any, bool] = {}


def _is_view(func) -> bool:
    """True if every result of `func` aliases an input without writing it."""
    hit = _VIEWS.get(func)
    if hit is None:
        rets = func._schema.returns
        hit = bool(rets) and all(
            r.alias_info is not None and not r.alias_info.is_write for r in rets)
        _VIEWS[func] = hit
    return hit


def _tensors(tree) -> list:
    """The tensors of `tree`, a DTensor as its local shard (what this
    rank holds)."""
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a kernel moves for `t`: its elements, but no more than its
    storage holds (a broadcast view reads its storage once)."""
    n = t.numel()
    try:
        n = min(n, t.untyped_storage().nbytes() // max(t.element_size(), 1))
    except (NotImplementedError, RuntimeError):
        pass
    return n * t.element_size()


def _product_flops(name: str, args, out) -> float:
    """2 · prod(result) · contraction of a product op, else 0."""
    if name in ("mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot"):
        a = args[1] if name.startswith("add") or name == "baddbmm" else args[0]
        if name in ("dot", "vdot"):
            return 2.0 * a.numel()
        res = out.numel() if name != "addbmm" else out.numel() * a.shape[0]
        return 2.0 * res * a.shape[-1]
    if name == "convolution":
        w = args[1]
        return 2.0 * out.numel() * (w.numel() // w.shape[0])
    return 0.0


def _bincount_meta(args, kwargs):
    """aten::bincount on meta tensors: its result's shape is its data's,
    so the counter takes the (minlength,) a bounded input gives."""
    weights = args[1] if len(args) > 1 else kwargs.get("weights")
    minlength = args[2] if len(args) > 2 else kwargs.get("minlength", 0)
    dtype = weights.dtype if weights is not None else torch.int64
    return torch.empty((int(minlength),), dtype=dtype, device=args[0].device)


class Counter(TorchDispatchMode):
    """Counts what the ops dispatched inside it do (`cost`; by op name in
    `flops_by`, `bytes_by`, `coll_by` with `attribute`), and follows the
    bytes of live tensor storages: those `track`ed before the call and
    every one an op makes, until it is freed (`live`, `peak`)."""

    def __init__(self, attribute: bool = False):
        super().__init__()
        self.cost = Cost()
        self.attribute = attribute
        self.flops_by: Dict[str, float] = {}
        self.bytes_by: Dict[str, float] = {}
        self.coll_by: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}
        self._zeros: Optional[weakref.ref] = None  # the last new_zeros result

    def _free(self, key: int, nbytes: int) -> None:
        self._refs.pop(key, None)
        self.live -= nbytes

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        nbytes = st.nbytes()
        self._refs[key] = weakref.ref(
            st, lambda _ref, key=key, nbytes=nbytes: self._free(key, nbytes))
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def track(self, tree) -> None:
        """Count the storages of the tensors in `tree` (modules: their
        parameters and buffers) as live."""
        for t in _tensors(_expand_modules(tree)):
            self._hold(t)

    def storages(self, tree) -> set:
        return {id(t.untyped_storage()) for t in _tensors(_expand_modules(tree))}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run it: its local ops and the collectives it
            # issues for its inputs come back here, on this rank's shards
            return NotImplemented
        kwargs = kwargs or {}
        zeros, self._zeros = self._zeros, None
        if func in _IN_PLACE and zeros is not None and args[0] is zeros():
            func = _IN_PLACE[func]
        if func is aten.bincount.default and args[0].device.type == "meta":
            out = _bincount_meta(args, kwargs)
        else:
            out = func(*args, **kwargs)
        name = _name(func)
        if name == "new_zeros":
            self._zeros = weakref.ref(out)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        c = self.cost
        c.ops += 1
        flops = 0.0
        if outs:
            prod = _product_flops(name, args, outs[0])
            if prod:
                flops = prod
                c.product_flops += prod
            elif name in ELEMENTWISE:
                if name != "_to_copy" or outs[0].dtype != ins[0].dtype:
                    flops = float(outs[0].numel())
            elif name in REDUCTIONS and ins:
                flops = float(ins[0].numel())
        nbytes = 0
        if not _is_view(func) and name not in _UNWRITTEN:
            nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        c.flops += flops
        c.hbm_bytes += nbytes
        coll = 0
        kind = (COLLECTIVE_KINDS.get(func.overloadpacket.__name__)
                if func.namespace in COLLECTIVE_NAMESPACES else None)
        if kind is not None:
            coll = sum(_nbytes(t) for t in ins)
            c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + coll
            group = kwargs.get("group_name") or next(
                (a for a in reversed(args) if isinstance(a, str)), "?")
            c.collective_groups[group] = c.collective_groups.get(group, 0.0) + coll
        if self.attribute:
            for table, v in ((self.flops_by, flops), (self.bytes_by, nbytes),
                             (self.coll_by, coll)):
                if v:
                    table[name] = table.get(name, 0.0) + v
        for t in outs:
            self._hold(t)
        return out


def _expand_modules(tree):
    """`tree` with every nn.Module replaced by its parameters and buffers."""
    def expand(x):
        if isinstance(x, torch.nn.Module):
            return list(x.parameters()) + list(x.buffers())
        return x
    return pytree.tree_map(expand, tree,
                           is_leaf=lambda x: isinstance(x, torch.nn.Module))


@dataclasses.dataclass
class Trace:
    cost: Cost
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    peak_bytes: int
    result: Any = None
    counter: Optional[Counter] = None

    @property
    def temp_bytes(self) -> int:
        """The peak's bytes beyond the arguments and the new outputs."""
        return max(0, self.peak_bytes - self.argument_bytes - self.output_bytes)


def trace(fn, *args, attribute: bool = False, **kwargs) -> Trace:
    """Run `fn(*args, **kwargs)` under a `Counter`: its cost, and its
    memory — the arguments' storages (live before the call), the result's
    storages that are new (outputs) or the arguments' own (aliases), and
    the peak of live storage bytes during the call, arguments included."""
    counter = Counter(attribute=attribute)
    counter.track((args, kwargs))
    arg_bytes = counter.live
    arg_ids = counter.storages((args, kwargs))
    with counter:
        result = fn(*args, **kwargs)
    out_bytes = alias_bytes = 0
    seen = set()
    for t in _tensors(_expand_modules(result)):
        st = t.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        if id(st) in arg_ids:
            alias_bytes += st.nbytes()
        else:
            out_bytes += st.nbytes()
    return Trace(counter.cost, arg_bytes, out_bytes, alias_bytes, counter.peak,
                 result, counter)


def analyze(fn, *args, **kwargs) -> Cost:
    """The `Cost` of one call of `fn(*args, **kwargs)`."""
    return trace(fn, *args, **kwargs).cost


class Attribution:
    """FLOPs, HBM bytes and collective bytes of one call rolled up by aten
    op name — the dry run's 'profile' (the reference's rolls up by JAX
    op_name metadata)."""

    def __init__(self, fn, *args, **kwargs):
        counter = trace(fn, *args, attribute=True, **kwargs).counter
        self.flops_by = counter.flops_by
        self.bytes_by = counter.bytes_by
        self.coll_by = counter.coll_by

    def top(self, table: Dict[str, float], n: int = 15):
        return sorted(table.items(), key=lambda kv: -kv[1])[:n]


def profile(fn, *args, n: int = 15, **kwargs) -> Dict[str, list]:
    a = Attribution(fn, *args, **kwargs)
    return {
        "flops": a.top(a.flops_by, n),
        "hbm_bytes": a.top(a.bytes_by, n),
        "collective_bytes": a.top(a.coll_by, n),
    }
