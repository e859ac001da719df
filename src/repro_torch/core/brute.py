"""Brute-force oracles for validating every search implementation (host
numpy, f64; a copy of the reference package's `core/brute.py`)."""
from __future__ import annotations

import numpy as np


def knn(points: np.ndarray, q: np.ndarray, k: int):
    d = np.sqrt(((points - q) ** 2).sum(axis=1))
    idx = np.argsort(d, kind="stable")[:k]
    return idx.astype(np.int64), d[idx]


def range_query(points: np.ndarray, q: np.ndarray, r: float):
    d = np.sqrt(((points - q) ** 2).sum(axis=1))
    m = d <= r
    idx = np.where(m)[0]
    o = np.argsort(d[idx], kind="stable")
    return idx[o].astype(np.int64), d[idx][o]


def constrained_knn(points: np.ndarray, q: np.ndarray, k: int, r: float):
    idx, d = range_query(points, q, r)
    return idx[:k], d[:k]
