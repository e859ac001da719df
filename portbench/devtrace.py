"""A profiled slice of a run, read by the benchmark itself.

`profiled(fn, dev)` runs `fn` under `torch.profiler` and returns what
the per-layer readers need: the slice's wall seconds, the seconds in
which some operation ran on the device (the union of the device's
kernel, copy and set intervals), the device seconds of each wrapped
kernel call, the device operations that took most time, and the longest
idle gaps labelled by the host annotation that was open. The interval
arithmetic (union of device intervals, idle share = 1 - busy / wall) is
copied from `chip_smoke.py` `profile_pass`.

`KernelCalls` wraps the program's read-path kernel entries
(`repro_torch.kernels.ops.leaf_topk_l2_raw`, `leaf_topk_l2`, `topk_l2`)
from the benchmark's side for the slice: each call records its shapes
and runs inside a profiler range of its own. A call's device time is
that of every device operation launched inside its range, whatever it
is named: the operations between the first launched in the range and
the first launched after it, in the stream's order (the port launches
on one stream), so that launches the profiler does not see (the CUDA
kernels go through ctypes) are counted too.
"""
from __future__ import annotations

import bisect
import re
import time

PREFIX = "portbench.kernel."
SLICE = "portbench.slice"


def _leaf_raw_shape(q, cands, cgids, r, k, cscale=None):
    rows, c, d = cands.shape
    return ("leaf_topk", int(rows), int(c), int(d), int(k), cands.element_size())


def _leaf_shape(q, cands, cgids, r, k):
    rows, c, d = cands.shape
    return ("leaf_topk", int(rows), int(c), int(d), int(k), 4)


def _scan_shape(q, p, gids, r, k):
    return ("topk_l2", int(q.shape[0]), int(p.shape[0]), int(q.shape[1]), int(k))


SHAPES = {"leaf_topk_l2_raw": _leaf_raw_shape, "leaf_topk_l2": _leaf_shape,
          "topk_l2": _scan_shape}


class KernelCalls:
    """Context manager: while open, the entries of `ops` named in
    `SHAPES` are wrapped; `calls[i]` is call i's (kernel, *shape)."""

    def __init__(self, ops):
        self.ops = ops
        self.calls = []
        self._saved = {}

    def _wrap(self, fn, shape_of):
        import torch

        def wrapped(*args, **kwargs):
            i = len(self.calls)
            self.calls.append(shape_of(*args, **kwargs))
            with torch.profiler.record_function(f"{PREFIX}{i}"):
                return fn(*args, **kwargs)
        return wrapped

    def __enter__(self):
        for name, shape_of in SHAPES.items():
            fn = getattr(self.ops, name)
            self._saved[name] = fn
            setattr(self.ops, name, self._wrap(fn, shape_of))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.ops, name, fn)
        self._saved = {}


def _activity(ev) -> str:
    get = getattr(ev, "activity_type", None)
    return get() if get is not None else ""


# host-side CUDA runtime and driver calls (cudaLaunchKernel, cuLaunchKernelEx,
# cudaMemcpyAsync, ...), told apart by name where the profiler's events
# carry no activity type
RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def union_busy(intervals) -> tuple:
    """(busy length, merged intervals) of a list of (start, end)."""
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            if hi > merged[-1][1]:
                merged[-1][1] = hi
        else:
            merged.append([lo, hi])
    return sum(hi - lo for lo, hi in merged), merged


def read(prof, calls) -> dict:
    """Parse a finished profile (nanosecond clock of the profiler)."""
    evs = list(prof.profiler.kineto_results.events())
    annotations, device, launches = [], [], {}
    for ev in evs:
        kind = _activity(ev)
        if ev.is_user_annotation() and str(ev.device_type()).endswith("CPU"):
            annotations.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name()))
        elif str(ev.device_type()).endswith("CUDA"):
            if ev.is_user_annotation() or kind == "gpu_user_annotation":
                continue
            device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                           ev.name(), ev.correlation_id()))
        elif kind in ("cuda_runtime", "cuda_driver") or (
                not kind and RUNTIME.match(ev.name())):
            launches[ev.correlation_id()] = ev.start_ns()
    host_names = {name for _, _, name in annotations}
    device = sorted(d for d in device if d[2] not in host_names)
    slice_ann = [a for a in annotations if a[2] == SLICE]
    if slice_ann:
        w0, w1 = slice_ann[0][0], slice_ann[0][1]
    elif device:
        w0, w1 = device[0][0], max(d[1] for d in device)
    else:
        w0 = w1 = 0
    busy_ns, merged = union_busy([(d[0], d[1]) for d in device])
    # device seconds of each wrapped call: the stream-ordered run of
    # operations from the first launched inside its range up to the first
    # launched after it
    launch_at = [launches.get(d[3]) for d in device]
    known = [(t, i) for i, t in enumerate(launch_at) if t is not None]
    known.sort()
    known_t = [t for t, _ in known]
    per_call = {}
    unresolved = 0
    for a0, a1, name in annotations:
        if not name.startswith(PREFIX):
            continue
        idx = int(name[len(PREFIX):])
        lo, hi = bisect.bisect_left(known_t, a0), bisect.bisect_right(known_t, a1)
        inside = [i for _, i in known[lo:hi]]
        if not inside:
            unresolved += 1
            continue
        first = min(inside)
        after = [i for _, i in known[hi:] if i > max(inside)]
        stop = min(after) if after else len(device)
        per_call[idx] = sum(d[1] - d[0] for d in device[first:stop]) / 1e9
    by_name = {}
    for d in device:
        by_name[d[2]] = by_name.get(d[2], 0.0) + (d[1] - d[0]) / 1e9
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # idle gaps inside the slice, by the innermost host annotation open
    # at the gap's middle
    gaps = []
    edge = w0
    for lo, hi in merged:
        if lo > edge:
            gaps.append((edge, min(lo, w1)))
        edge = max(edge, hi)
    if w1 > edge:
        gaps.append((edge, w1))
    spans = sorted((a for a in annotations
                    if a[2] != SLICE and not a[2].startswith(PREFIX)),
                   key=lambda a: a[0])
    starts = [a[0] for a in spans]
    idle_by = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label = "outside any span"
        best = None
        for a in spans[:bisect.bisect_right(starts, mid)]:
            if a[1] >= mid and (best is None or a[0] >= best[0]):
                best = a
        if best is not None:
            label = best[2]
        idle_by[label] = idle_by.get(label, 0.0) + (g1 - g0) / 1e9
    idle_gaps = sorted(idle_by.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "device_events": len(device),
        "calls": calls,
        "call_device_s": per_call,
        "unresolved_calls": unresolved,
        "device_s_by_name": by_name,
        "top_ops": [[n, s] for n, s in top_ops],
        "idle_gaps": [[n, s] for n, s in idle_gaps],
    }


def profiled(fn, dev, ops) -> dict:
    """Run `fn()` once under the profiler, with the kernel entries of
    `ops` wrapped, and read the slice."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with KernelCalls(ops) as kc, profile(activities=acts) as prof:
        with record_function(SLICE):
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
    profiled_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = read(prof, kc.calls)
    out["profiled_s"] = profiled_s
    out["read_s"] = time.perf_counter() - t0
    return out
