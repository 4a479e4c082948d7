"""Shape bucketing: pad leading dims so jitted passes compile once per
bucket instead of once per input length.

Buckets are 1/8-octave above ``_FINE_FROM`` (steps of 2^k/8, max 12.5%
pad — a pow2-only policy wastes up to 2x device work on unlucky sizes:
an 8 MiB d3 stream's 349525 blocks padded to 524288) and
pure powers of two below it (small shapes don't care, and fewer buckets
= fewer compiles). ``pow2=True`` keeps the old policy for MINOR-dim
buckets, where non-pow2 sizes pad badly in the tile layout itself
(the unpack's maxb; huffman's lane-axis chunk count).
"""

from __future__ import annotations

import numpy as np

_FINE_FROM = 4096


def next_bucket(n: int, minimum: int = 16, pow2: bool = False) -> int:
    """Smallest bucket >= max(n, minimum) (policy above)."""
    b = minimum
    while b < n:
        b <<= 1
    if pow2 or b <= _FINE_FROM:
        return b
    half = b >> 1
    if half >= n:  # n <= minimum with a big minimum
        return b
    step = half >> 3
    return half + -(-(n - half) // step) * step


def pad_rows(arr: np.ndarray, target_rows: int) -> np.ndarray:
    """Zero-pad axis 0 of ``arr`` to ``target_rows``."""
    if arr.shape[0] == target_rows:
        return arr
    pad = [(0, target_rows - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)
