"""Grouped-finish v2 and native-d3 fold exactness.

Both knobs are trace-time layout choices that must be bit-invisible:
v2 keeps the N-scale offset add full-lane (session-11 padding cliff),
native d3 folds g=42 real blocks instead of a zero-width 4th dim.
Every combination must decode byte-identically on contiguous AND
runs streams (the scatter finish shares _grouped_prefix_finish).
"""

import itertools

import jax
import numpy as np
import pytest

import sprintz_jax.decoder as dec
import sprintz_jax.ops.pack as pack
from sprintz_jax import encoder


@pytest.fixture(params=list(itertools.product(["v1", "v2"],
                                              ["fold4", "native"])))
def finish_cfg(request):
    fin, d3 = request.param
    prev = dec.GROUPED_FINISH, dec.LOWDIM_D3, pack.LOWDIM_D3
    dec.GROUPED_FINISH, dec.LOWDIM_D3, pack.LOWDIM_D3 = fin, d3, d3
    jax.clear_caches()
    yield fin, d3
    dec.GROUPED_FINISH, dec.LOWDIM_D3, pack.LOWDIM_D3 = prev
    jax.clear_caches()


@pytest.mark.parametrize("ndims,elem_sz", [(1, 1), (2, 1), (3, 1), (4, 1),
                                           (1, 2), (2, 2)])
@pytest.mark.parametrize("runs", [False, True])
def test_grouped_roundtrip(rng, finish_cfg, ndims, elem_sz, runs):
    dt = np.uint8 if elem_sz == 1 else np.uint16
    nrows = 8 * 700  # non-pow2 block count: exercises group padding
    seg = rng.integers(-6, 7, (nrows, ndims))
    if runs:
        m = (np.arange(nrows) // 64 % 3 == 0)[:, None]
        seg = np.where(m, 0, seg)
    raw = (np.cumsum(seg, axis=0) % (1 << (8 * elem_sz))).astype(dt)
    prev = dec.LOWDIM_PASS
    dec.LOWDIM_PASS = "grouped"  # force grouped (incl. scatter runs path)
    try:
        s = encoder.compress(raw.reshape(-1), ndims, codec="delta",
                             elem_sz=elem_sz)
        out = dec.decompress(s, codec="delta", elem_sz=elem_sz)
    finally:
        dec.LOWDIM_PASS = prev
    np.testing.assert_array_equal(out, raw.reshape(-1))


@pytest.mark.parametrize("ndims,elem_sz", [(3, 1), (4, 1)])
def test_grouped_seek_state(rng, finish_cfg, ndims, elem_sz):
    """decode_range carries forecaster state through the finish's
    ``state`` argument — both finish versions must agree."""
    from sprintz_jax import checkpoint

    dt = np.uint8 if elem_sz == 1 else np.uint16
    nrows = 8 * 600
    raw = (np.cumsum(rng.integers(-5, 6, (nrows, ndims)), axis=0)
           % (1 << (8 * elem_sz))).astype(dt)
    prev = dec.LOWDIM_PASS
    dec.LOWDIM_PASS = "grouped"
    try:
        s, sc = checkpoint.compress_with_sidecar(
            raw.reshape(-1), ndims, codec="delta", every_groups=4)
        got = checkpoint.decode_range(s, sc, 1600, 2400)
    finally:
        dec.LOWDIM_PASS = prev
    np.testing.assert_array_equal(
        np.asarray(got).reshape(-1),
        raw.reshape(-1)[1600 * ndims:4000 * ndims])
