"""First principal component via power iteration, host numpy (a copy of
the reference package's `core/pca.py`; the device version is
`kernels.ops.power_iteration`).

The paper (§3.2) needs only the single most significant eigenvector
w₁ = argmax wᵀXᵀXw / wᵀw of the *centered* data. Power iteration on the
covariance is O(iters · n · d) — the same complexity class as one pass over
the node's points, keeping the split cost O(n) as the paper claims.
"""
from __future__ import annotations

import numpy as np


def _deterministic_init(d: int, seed: int = 0) -> np.ndarray:
    """A fixed, non-axis-aligned start vector (reproducible builds)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(d)
    return v / np.linalg.norm(v)


def first_component_host(
    x: np.ndarray, iters: int = 16, seed: int = 0
) -> np.ndarray:
    """First principal component of x (n, d), host numpy.

    Uses power iteration on the centered Gram product without materializing
    the covariance matrix: v ← Xcᵀ(Xc v).
    """
    x = np.asarray(x, dtype=np.float64)
    mu = x.mean(axis=0)
    xc = x - mu
    v = _deterministic_init(x.shape[1], seed)
    for _ in range(iters):
        v_new = xc.T @ (xc @ v)
        nrm = np.linalg.norm(v_new)
        if nrm < 1e-12:  # degenerate node: all points identical
            return v
        v = v_new / nrm
    return v


def first_component_exact(x: np.ndarray) -> np.ndarray:
    """Exact first eigenvector via dense eigendecomposition (test oracle)."""
    x = np.asarray(x, dtype=np.float64)
    xc = x - x.mean(axis=0)
    cov = xc.T @ xc
    w, v = np.linalg.eigh(cov)
    return v[:, -1]
