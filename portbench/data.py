"""Point and query generators of the benchmark, frozen.

Copied from `src/repro_torch/data/synthetic.py` (`highleyman`,
`uniform_queries`). The program's copies may change; these do not, so the
data a seed gives stays the same across every later change.
All generators draw from a `numpy.random.Generator` that the caller
seeds, so the same seed gives the same points.
"""
from __future__ import annotations

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one named stream of a run's seed. Any whole number
    is a valid seed (negative ones and ones above 2**63 are taken modulo
    2**64)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2**64, *stream]))


def highleyman(n: int, d: int, rng: np.random.Generator) -> np.ndarray:
    """Highleyman's classes (prtools `gendath`): a two-Gaussian mixture
    with very different shapes, one elongated, one compact."""
    n1 = n // 2
    n2 = n - n1
    c1 = rng.multivariate_normal([1.0, 1.0], np.diag([1.0, 0.25]), size=n1)
    c2 = rng.multivariate_normal([2.0, 0.0], np.diag([0.01, 4.0]), size=n2)
    pts = np.vstack([c1, c2])
    if d > 2:
        pad = rng.standard_normal((n, d - 2)) * 0.05
        pts = np.hstack([pts, pad])
    return rng.permutation(pts, axis=0)


GENERATORS = {"highleyman": highleyman}


def points(generator: str, n: int, d: int, rng: np.random.Generator) -> np.ndarray:
    """`n` points of `generator` in `d` dimensions, as float32 (what the
    index and the reference both receive)."""
    return GENERATORS[generator](n, d, rng).astype(np.float32)


def uniform_queries(lo: np.ndarray, hi: np.ndarray, n: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Queries uniform in the box [lo, hi] (the paper's §5.1: "randomly
    drawn with uniform distribution in same range of values")."""
    return rng.uniform(lo, hi, size=(n, len(lo))).astype(np.float32)

