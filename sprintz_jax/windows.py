"""Sliding-window statistics and similarity search primitives.

Capability parity with the reference's vestigial search layer
(search.hpp:29-285: OnlineMean, windowed L2 / dot / correlation) in a
vectorized formulation: running sums become prefix sums, window dot
products become a correlation matmul over lagged frames — no per-window
loops.
"""

from __future__ import annotations

import numpy as np


def _prefix(x: np.ndarray) -> np.ndarray:
    """Exclusive prefix sum with a leading zero (float64)."""
    return np.concatenate([[0.0], np.cumsum(x, dtype=np.float64)])


class OnlineMean:
    """Streaming mean with O(1) updates (search.hpp OnlineMean)."""

    def __init__(self):
        self._sum = 0.0
        self._count = 0

    def insert(self, x: float):
        self._sum += x
        self._count += 1

    def remove(self, x: float):
        self._sum -= x
        self._count -= 1

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0


def window_sums(x: np.ndarray, m: int) -> np.ndarray:
    """Sum of every length-m window: prefix-sum difference."""
    p = _prefix(np.asarray(x, dtype=np.float64))
    return p[m:] - p[:-m]


def window_means(x: np.ndarray, m: int) -> np.ndarray:
    return window_sums(x, m) / m


def window_dot(x: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Dot product of query q against every window of x (valid mode)."""
    x = np.asarray(x, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    return np.correlate(x, q, mode="valid")


def window_l2(x: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Squared L2 distance of q to every window:
    ||w||^2 - 2 w.q + ||q||^2 via prefix sums + one correlation."""
    x = np.asarray(x, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    m = q.size
    wsq = window_sums(x * x, m)
    return np.maximum(wsq - 2.0 * window_dot(x, q) + float(q @ q), 0.0)


def window_corr(x: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Pearson correlation of q with every window (z-normalized matching)."""
    x = np.asarray(x, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    m = q.size
    qz = q - q.mean()
    qnorm = np.sqrt(float(qz @ qz))
    mu = window_means(x, m)
    wsq = window_sums(x * x, m)
    var = np.maximum(wsq - m * mu * mu, 0.0)
    denom = np.sqrt(var) * qnorm
    num = window_dot(x, qz)  # sum w*qz == sum (w - mu)*qz
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(denom > 0, num / denom, 0.0)
    return np.clip(out, -1.0, 1.0)


def knn_windows(x: np.ndarray, q: np.ndarray, k: int = 1,
                metric: str = "l2") -> tuple[np.ndarray, np.ndarray]:
    """Top-k most similar windows of x to q. Returns (indices, scores)."""
    if metric == "l2":
        d = window_l2(x, q)
        idx = np.argsort(d)[:k]
        return idx, d[idx]
    if metric == "corr":
        c = window_corr(x, q)
        idx = np.argsort(-c)[:k]
        return idx, c[idx]
    if metric == "dot":
        d = window_dot(x, q)
        idx = np.argsort(-d)[:k]
        return idx, d[idx]
    raise ValueError(metric)
