"""Flat-param lowdim delta encode must be bit-invisible.

Sessions 40/41: the (N, D<=4) jit param layout was the encode floor;
the flat front-end computes zigzag deltas with one D-element lane
shift. Streams must stay byte-identical to the 2-D pass (and thus to
the reference encoder) for every lowdim config, including the RLE/runs
structure and the verbatim tail.
"""

import numpy as np
import pytest

import sprintz_jax.encoder as enc
from sprintz_jax import decoder


@pytest.fixture(params=["auto", "all", "0"])
def encode_flat(request):
    prev = enc.ENCODE_FLAT
    enc.ENCODE_FLAT = request.param
    yield request.param
    enc.ENCODE_FLAT = prev


@pytest.mark.parametrize("ndims,elem_sz", [(1, 1), (2, 1), (3, 1), (4, 1),
                                           (1, 2), (2, 2)])
@pytest.mark.parametrize("runs", [False, True])
def test_flat_streams_byte_identical(rng, encode_flat, ndims, elem_sz, runs):
    dt = np.uint8 if elem_sz == 1 else np.uint16
    nrows = 8 * 531 + 5  # ragged tail exercises the verbatim remainder
    seg = rng.integers(-6, 7, (nrows, ndims))
    if runs:
        seg[np.arange(nrows) // 64 % 3 == 0] = 0
    raw = (np.cumsum(seg, axis=0) % (1 << (8 * elem_sz))).astype(dt)
    flat = raw.reshape(-1)
    s = enc.compress(flat, ndims, codec="delta", elem_sz=elem_sz)
    prev = enc.ENCODE_FLAT
    enc.ENCODE_FLAT = "0"
    try:
        ref = enc.compress(flat, ndims, codec="delta", elem_sz=elem_sz)
    finally:
        enc.ENCODE_FLAT = prev
    assert s == ref
    np.testing.assert_array_equal(
        decoder.decompress(s, codec="delta", elem_sz=elem_sz), flat)
