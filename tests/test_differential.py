"""Differential fuzzing: golden vs JAX paths on fresh random streams.

The framework's analogue of the reference's (absent) sanitizers: every
run draws new seeds, so divergence between the executable spec and the
production path surfaces over time rather than only on fixed fixtures.
"""

import os
import secrets

import numpy as np
import pytest

from sprintz_jax import decoder, encoder
from sprintz_jax.golden.lowdim import compress_lowdim_rle
from sprintz_jax.golden.rowmajor import compress_rowmajor_rle

SEED = int(os.environ.get("SPRINTZ_FUZZ_SEED", secrets.randbits(32)))
N_CASES = int(os.environ.get("SPRINTZ_FUZZ_CASES", 6))


@pytest.mark.parametrize("case", range(N_CASES))
def test_fuzz_jax_matches_golden(case):
    rng = np.random.default_rng(SEED + case)
    codec = ["delta", "xff"][case % 2]
    elem_sz = [1, 2][(case // 2) % 2]
    ndims = int(rng.integers(1, 24))
    nrows = int(rng.integers(1, 240)) * 8 + int(rng.integers(0, 9))
    dt = np.uint8 if elem_sz == 1 else np.uint16
    hi = 1 << (8 * elem_sz)
    style = rng.random()
    if style < 0.3:
        x = rng.integers(0, hi, nrows * ndims).astype(dt)
    elif style < 0.7:
        x = np.where(rng.random(nrows * ndims) < rng.random() * 0.3,
                     rng.integers(0, hi, nrows * ndims), 0).astype(dt)
    else:
        x = (np.cumsum(rng.integers(-9, 10, nrows * ndims)) % hi).astype(dt)
    lowdim = ndims <= (4 if elem_sz == 1 else 2)
    gold = (compress_lowdim_rle if lowdim else compress_rowmajor_rle)(
        x, ndims, codec=codec)
    mine = encoder.compress(x, ndims, codec=codec)
    assert mine == gold, f"seed={SEED} case={case} d={ndims} n={nrows}"
    dec = decoder.decompress(mine, codec=codec, elem_sz=elem_sz)
    np.testing.assert_array_equal(
        dec, x, err_msg=f"seed={SEED} case={case}")
