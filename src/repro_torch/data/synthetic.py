"""Synthetic point distributions from the paper's evaluation (§5).

The paper uses 5 synthetic 2-D datasets of 500k points — Latin-center,
Highleyman, Niederreiter, Lithuanian, Sobol — plus two 4-D real-world
datasets (UCI Skin Segmentation, 3D Road Network). The sandbox is offline,
so the two "real-world" sets are reproduced as statistically similar
stand-ins (clustered RGB-like mixture; spatially-correlated road traces);
this is noted in EXPERIMENTS.md.

All generators are deterministic given `seed`.
"""
from __future__ import annotations

import numpy as np

try:  # scipy is available in this sandbox; guard anyway
    from scipy.stats import qmc

    _HAVE_QMC = True
except Exception:  # pragma: no cover
    _HAVE_QMC = False


def latin_center(n: int, d: int = 2, seed: int = 0) -> np.ndarray:
    """Latin hypercube design with points at cell centers [11]."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, d))
    centers = (np.arange(n) + 0.5) / n
    for j in range(d):
        out[:, j] = rng.permutation(centers)
    return out


def sobol(n: int, d: int = 2, seed: int = 0) -> np.ndarray:
    """Sobol low-discrepancy sequence [1]."""
    if _HAVE_QMC:
        eng = qmc.Sobol(d=d, scramble=True, seed=seed)
        return eng.random(n)
    return _van_der_corput_grid(n, d)  # pragma: no cover


def niederreiter(n: int, d: int = 2, seed: int = 0) -> np.ndarray:
    """Niederreiter-class low-discrepancy sequence [30].

    scipy ships no Niederreiter generator; we use the Halton sequence — a
    member of the same low-discrepancy family with very similar spatial
    statistics — as the offline stand-in (noted in EXPERIMENTS.md).
    """
    if _HAVE_QMC:
        eng = qmc.Halton(d=d, scramble=True, seed=seed)
        return eng.random(n)
    return _van_der_corput_grid(n, d)  # pragma: no cover


def highleyman(n: int, d: int = 2, seed: int = 0) -> np.ndarray:
    """Highleyman's classes (prtools `gendath` [13]): a two-Gaussian
    mixture with very different shapes — one elongated, one compact."""
    rng = np.random.default_rng(seed)
    n1 = n // 2
    n2 = n - n1
    c1 = rng.multivariate_normal([1.0, 1.0], np.diag([1.0, 0.25]), size=n1)
    c2 = rng.multivariate_normal([2.0, 0.0], np.diag([0.01, 4.0]), size=n2)
    pts = np.vstack([c1, c2])
    if d > 2:
        pad = rng.standard_normal((n, d - 2)) * 0.05
        pts = np.hstack([pts, pad])
    return rng.permutation(pts, axis=0)


def lithuanian(n: int, d: int = 2, seed: int = 0) -> np.ndarray:
    """Lithuanian classes (prtools `gendatl` [13]): two interleaved
    banana-shaped arcs with Gaussian noise."""
    rng = np.random.default_rng(seed)
    n1 = n // 2
    n2 = n - n1

    def arc(m, center, phase, radius):
        a = rng.uniform(0.0, np.pi, size=m) + phase
        x = center[0] + radius * np.cos(a)
        y = center[1] + radius * np.sin(a)
        return np.stack([x, y], axis=1) + rng.standard_normal((m, 2)) * 0.35
    c1 = arc(n1, (0.0, 0.0), 0.0, 2.0)
    c2 = arc(n2, (2.0, -1.0), np.pi, 2.0)
    pts = np.vstack([c1, c2])
    if d > 2:
        pad = rng.standard_normal((n, d - 2)) * 0.05
        pts = np.hstack([pts, pad])
    return rng.permutation(pts, axis=0)


def skin_like(n: int, d: int = 4, seed: int = 0) -> np.ndarray:
    """Stand-in for the UCI Skin Segmentation set: RGB-like values in
    [0, 255] drawn from a few anisotropic clusters + a label-ish 4th dim."""
    rng = np.random.default_rng(seed)
    k = 5
    means = rng.uniform(40, 220, size=(k, 3))
    covs = [np.diag(rng.uniform(5, 45, size=3) ** 2) for _ in range(k)]
    comp = rng.integers(0, k, size=n)
    pts3 = np.stack(
        [rng.multivariate_normal(means[c], covs[c]) for c in comp]
    )
    pts3 = np.clip(pts3, 0, 255)
    lab = (comp < 2).astype(np.float64) * 255.0
    lab += rng.standard_normal(n) * 2.0
    out = np.hstack([pts3, lab[:, None]])
    if d != 4:
        out = out[:, :d]
    return out


def road_like(n: int, d: int = 4, seed: int = 0) -> np.ndarray:
    """Stand-in for the 3D Road Network set: spatially-correlated traces
    (random-walk polylines) in (lon, lat) with smooth altitude + arc id."""
    rng = np.random.default_rng(seed)
    n_roads = max(1, n // 500)
    pts = []
    rid = []
    remaining = n
    for i in range(n_roads):
        m = min(remaining, 500 if i < n_roads - 1 else remaining)
        start = rng.uniform(-1.0, 1.0, size=2) * np.array([10.0, 5.0])
        heading = rng.uniform(0, 2 * np.pi)
        step = 0.002
        turns = rng.standard_normal(m).cumsum() * 0.05 + heading
        xy = start + np.stack(
            [np.cos(turns).cumsum() * step, np.sin(turns).cumsum() * step],
            axis=1,
        )
        alt = 100 + 30 * np.sin(np.linspace(0, 3, m) + i) + \
            rng.standard_normal(m).cumsum() * 0.2
        pts.append(np.hstack([xy, alt[:, None]]))
        rid.append(np.full(m, float(i)))
        remaining -= m
        if remaining <= 0:
            break
    out = np.hstack([np.vstack(pts), np.concatenate(rid)[:, None]])
    if d != 4:
        out = out[:, :d]
    return rng.permutation(out, axis=0)


def _van_der_corput_grid(n: int, d: int) -> np.ndarray:  # pragma: no cover
    """Fallback quasi-uniform grid when scipy.qmc is unavailable."""
    primes = [2, 3, 5, 7, 11, 13, 17, 19][:d]

    def vdc(i, base):
        f, r = 1.0, 0.0
        while i > 0:
            f /= base
            r += f * (i % base)
            i //= base
        return r
    return np.array(
        [[vdc(i + 1, b) for b in primes] for i in range(n)]
    )


SYNTHETIC = {
    "latin-center": latin_center,
    "highleyman": highleyman,
    "niederreiter": niederreiter,
    "lithuanian": lithuanian,
    "sobol": sobol,
}

REAL_WORLD_LIKE = {
    "skin-segmentation": skin_like,
    "3d-road-network": road_like,
}

ALL_DATASETS = {**SYNTHETIC, **REAL_WORLD_LIKE}


def make(name: str, n: int, d: int | None = None, seed: int = 0) -> np.ndarray:
    fn = ALL_DATASETS[name]
    default_d = 2 if name in SYNTHETIC else 4
    return fn(n, d or default_d, seed)


def uniform_queries(
    points: np.ndarray, n_queries: int, seed: int = 1
) -> np.ndarray:
    """Query workload as in §5.1: uniformly random in the data's bounding
    box ("randomly drawn with uniform distribution in same range of values
    in each dataset")."""
    rng = np.random.default_rng(seed)
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    return rng.uniform(lo, hi, size=(n_queries, points.shape[1]))
