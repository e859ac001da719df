"""The comparison that decides `correct`.

Each answered query of the window (or a sample drawn from the run's
seed) is held against the plain reference (`reference/brute.py`) over
the live set it was due at, from the benchmark's own account of
acknowledged writes. The numbers, each with its limit from the cell's
file (`workloads/<cell>.json`):

  sq_gap    the widest gap between the answer's i-th squared distance
            and the reference's i-th, both clipped at r, over r². Ties
            between points swap ids but not distances, so this is exact
            up to the float32 rounding of a squared distance, which is
            of the order of 2^-24 (|q|² + |p|²) in either of the
            program's forms (the leaf kernel's difference form, the
            arena scan's expansion form); an unfilled slot reads as r,
            so a missed or an extra neighbour at the radius reads as
            small as its distance from the radius, one far inside reads
            large.
  id_sq_gap the widest gap between an answer's squared distance and the
            reference's float64 squared distance from the query to the
            point the answer names, over r²: an id altered where it is
            produced.
  bad_ids   answers naming a point not live when the query ran, or the
            same point twice in one answer (exact, limit 0).
  failed    requests or batches that raised, were refused or never
            answered (exact, limit 0).
  lost_acks updates whose delete did not find the point live or whose
            add returned no id (exact, limit 0; update cells).

A number that cannot be read (NaN) is written as NO_NUMBER, which fails
any limit.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import brute

NO_NUMBER = 1e9


def _finite(x: float) -> float:
    return float(x) if np.isfinite(x) else NO_NUMBER


def by_live_set(account, q, pos, k, r, dev, dtype=torch.float64):
    """Reference answers (distances, gids) of queries `q` due at account
    positions `pos`, each over its own live set."""
    out_d = np.full((len(q), k), np.inf)
    out_g = np.full((len(q), k), -1, np.int64)
    masks = {}
    for p, live in account.live_masks(pos.tolist()):
        rows = np.nonzero(pos == p)[0]
        gids = np.nonzero(live)[0]
        d, g = brute.constrained_knn(account.points[gids], gids, q[rows], k, r,
                                     dev, dtype=dtype)
        out_d[rows], out_g[rows] = d, g
        masks[p] = live.copy()
    return out_d, out_g, masks


def numbers(account, q, g, d, pos, k, r, dev) -> dict:
    """sq_gap, id_sq_gap and bad_ids of answers (g, d) to queries q."""
    ref_d, _, masks = by_live_set(account, q, pos, k, r, dev)
    d = np.asarray(d, np.float64)
    clip = lambda x: np.minimum(np.where(np.isnan(x), np.inf, x), r)  # noqa: E731
    gap = np.abs(clip(d) ** 2 - clip(ref_d) ** 2) / r**2
    sq_gap = np.nan if np.isnan(d).any() else float(gap.max(initial=0.0))
    id_gap, bad = 0.0, 0
    for p, live in masks.items():
        rows = np.nonzero(pos == p)[0]
        true, stale = brute.distances_of(account.points, live, q[rows], g[rows])
        has = (g[rows] >= 0) & ~stale
        if has.any():
            gap = np.abs(d[rows][has] ** 2 - true[has] ** 2) / r**2
            id_gap = max(id_gap, float(gap.max()))
        gs = np.sort(np.where(g[rows] >= 0, g[rows], -np.arange(1, k + 1)), axis=1)
        dup = (np.diff(gs, axis=1) == 0).sum()
        bad += int(stale.sum() + dup)
    return {"sq_gap": _finite(sq_gap), "id_sq_gap": _finite(id_gap), "bad_ids": bad}


def control_answers(account, q, pos, k, r, dev) -> tuple:
    """The control in the program's place: the reference computed in
    bfloat16. Returns (gids, distances)."""
    d, g, _ = by_live_set(account, q, pos, k, r, dev, dtype=torch.bfloat16)
    return g, d.astype(np.float32)


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number without a value fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name, NO_NUMBER)
        out[name] = {"value": v, "limit": limit}
        ok = ok and v <= limit
    return ok, out


def sample_rows(n: int, size: int, rng) -> np.ndarray:
    """`size` of n rows drawn from the seed (all where size >= n)."""
    if size <= 0 or size >= n:
        return np.arange(n)
    return np.sort(rng.choice(n, size=size, replace=False))
