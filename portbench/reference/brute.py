"""Plain brute-force constrained k-NN: the reference that decides
`correct`, and its lower-precision control.

Written for the benchmark in plain PyTorch. It imports nothing of the
program (`repro_torch`) and nothing of the JAX package, and takes only
what the benchmark itself made: the live points with their global ids,
from its own account of acknowledged writes, and the queries.

Semantics (those of the index): the k nearest live points within
euclidean distance r of each query, ascending, (+inf, -1) where fewer
than k lie within r.

The reference computes in float64 over the float32 points the index was
given. Selection takes the expansion form on coordinates centred by
their mean (squared distances good to ~1e-12 of the data's extent),
then the k chosen distances are recomputed in the difference form.
The control (`dtype=torch.bfloat16`) rounds points and queries to
bfloat16 and computes in bfloat16 throughout: the answer one precision
below the float32 answers the configuration states.
"""
from __future__ import annotations

import numpy as np
import torch


def constrained_knn(points: np.ndarray, gids: np.ndarray, queries: np.ndarray,
                    k: int, r: float, device, dtype=torch.float64,
                    chunk: int = 256) -> tuple:
    """(distances (Q, k) float64, gids (Q, k) int64) by brute force over
    `points` (N, D) with global ids `gids` (N,), in blocks of `chunk`
    queries on `device`."""
    nq = len(queries)
    out_d = np.full((nq, k), np.inf)
    out_g = np.full((nq, k), -1, np.int64)
    if nq == 0 or len(points) == 0:
        return out_d, out_g
    p = torch.from_numpy(np.asarray(points)).to(device=device, dtype=torch.float64)
    q_all = torch.from_numpy(np.asarray(queries)).to(device=device, dtype=torch.float64)
    g = torch.from_numpy(np.asarray(gids, np.int64)).to(device)
    if dtype == torch.float64:
        centre = p.mean(dim=0)
        pc = p - centre
        pn = (pc * pc).sum(dim=1)
    else:
        pl = p.to(dtype)
    kk = min(k, len(points))
    for lo in range(0, nq, chunk):
        q = q_all[lo:lo + chunk]
        if dtype == torch.float64:
            qc = q - centre
            sq = ((qc * qc).sum(dim=1)[:, None] + pn[None, :]
                  - 2.0 * (qc @ pc.T)).clamp_min(0.0)
            r_sel = (r * (1.0 + 1e-9)) ** 2   # wide: the exact gate follows
        else:
            ql = q.to(dtype)
            sq = None
            for j in range(ql.shape[1]):
                t = ql[:, None, j] - pl[None, :, j]
                sq = t * t if sq is None else sq + t * t
            r_sel = r * r
        sq = torch.where(sq <= r_sel, sq, torch.full_like(sq, float("inf")))
        val, idx = torch.topk(sq, kk, dim=1, largest=False, sorted=True)
        if dtype == torch.float64:
            # exact distances of the chosen points, by the difference form
            diff = q[:, None, :] - p[idx]
            dist = torch.sqrt((diff * diff).sum(dim=2))
            keep = torch.isfinite(val) & (dist <= r)
            dist = torch.where(keep, dist, torch.full_like(dist, float("inf")))
            dist, order = torch.sort(dist, dim=1, stable=True)
            idx = idx.gather(1, order)
            keep = keep.gather(1, order)
        else:
            dist = torch.sqrt(val).to(torch.float64)
            keep = torch.isfinite(val)
        gg = torch.where(keep, g[idx], torch.full_like(idx, -1))
        out_d[lo:lo + chunk, :kk] = dist.cpu().numpy()
        out_g[lo:lo + chunk, :kk] = gg.cpu().numpy()
    return out_d, out_g


def distances_of(points_by_gid: np.ndarray, live: np.ndarray, queries: np.ndarray,
                 gids: np.ndarray) -> tuple:
    """float64 distance from each query to each of its answer's gids, and
    a mask of the answers that name a point not live (or no point at
    all) when the query ran. `gids` (Q, k) with -1 = no answer."""
    has = gids >= 0
    safe = np.where(has, gids, 0)
    inside = safe < len(live)
    safe = np.where(inside, safe, 0)
    stale = has & ~(inside & live[safe])
    diff = points_by_gid[safe].astype(np.float64) - queries.astype(np.float64)[:, None, :]
    dist = np.sqrt((diff * diff).sum(axis=2))
    return np.where(has, dist, np.inf), stale
