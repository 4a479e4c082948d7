"""Byte-exactness against the compiled reference implementation.

Skipped unless a locally-built reference library is present (see
``tests/oracle.py`` for build instructions). When available, every encoder
variant is checked byte-for-byte and decode is cross-checked both ways.
"""

import itertools

import numpy as np
import pytest

import oracle
from sprintz_jax import api
from sprintz_jax.golden.lowdim import compress_lowdim_rle
from sprintz_jax.golden.rowmajor import compress_rowmajor_rle

from conftest import KINDS, make_stream

pytestmark = pytest.mark.skipif(
    not oracle.available(), reason="reference oracle library not built")

SIZES = [1, 127, 128, 129, 512, 1000]


@pytest.mark.parametrize("codec,elem_sz", itertools.product(
    ["delta", "xff"], [1, 2]))
def test_rowmajor_byte_exact(rng, codec, elem_sz):
    refname = f"compress_{codec}_rle_{8 * elem_sz}b"
    for ndims in [1, 4, 5, 8, 17, 33, 64]:
        for sz in SIZES:
            for kind in KINDS:
                x = make_stream(rng, sz * ndims, elem_sz, kind)
                mine = compress_rowmajor_rle(x, ndims, codec=codec)
                ref = oracle.ref_compress(refname, x, ndims)
                oracle.assert_stream_matches(
                    mine, ref, f"{codec} {elem_sz}b ndims={ndims} sz={sz} {kind}")


@pytest.mark.parametrize("codec,elem_sz", itertools.product(
    ["delta", "xff"], [1, 2]))
def test_lowdim_byte_exact(rng, codec, elem_sz):
    refname = f"compress_{codec}_rle_lowdim_{8 * elem_sz}b"
    maxd = 4 if elem_sz == 1 else 2
    for ndims in range(1, maxd + 1):
        for sz in SIZES:
            for kind in KINDS:
                x = make_stream(rng, sz * ndims, elem_sz, kind)
                mine = compress_lowdim_rle(x, ndims, codec=codec)
                ref = oracle.ref_compress(refname, x, ndims)
                oracle.assert_stream_matches(
                    mine, ref,
                    f"lowdim {codec} {elem_sz}b ndims={ndims} sz={sz} {kind}")


@pytest.mark.parametrize("codec,elem_sz", itertools.product(
    ["delta", "xff"], [1, 2]))
def test_api_dispatch_and_cross_decode(rng, codec, elem_sz):
    for ndims in [1, 2, 4, 9]:
        sz = 600
        n = sz * ndims
        x = make_stream(rng, n, elem_sz, "sparse")
        sc = api.SprintzCodec(codec, elem_sz, backend="golden")
        mine = sc.compress(x.reshape(sz, ndims))
        ref = oracle.ref_compress(
            f"sprintz_compress_{codec}_{8 * elem_sz}b", x, ndims)
        oracle.assert_stream_matches(mine, ref, f"api {codec} {elem_sz}b d{ndims}")
        # the reference can decode our stream...
        dec_ref = oracle.ref_decompress(
            f"sprintz_decompress_{codec}_{8 * elem_sz}b", mine, n)
        np.testing.assert_array_equal(dec_ref, x)
        # ...and we can decode it too
        np.testing.assert_array_equal(sc.decompress(mine), x)
