"""Non-RLE codec variants: bitpack-only, delta, legacy 8b xff."""

import numpy as np
import pytest

from sprintz_jax.golden.stream import compress_simple, decompress_simple

from conftest import KINDS, make_stream


@pytest.mark.parametrize("codec,elem_sz", [
    ("raw", 1), ("raw", 2), ("delta", 1), ("delta", 2), ("xff", 1)])
def test_simple_roundtrip(rng, codec, elem_sz):
    for ndims in [1, 5, 16]:
        for sz in [1, 127, 128, 129, 600]:
            for kind in KINDS:
                x = make_stream(rng, sz * ndims, elem_sz, kind)
                buf = compress_simple(x, ndims, codec)
                dec = decompress_simple(buf, codec, elem_sz=elem_sz)
                np.testing.assert_array_equal(dec, x)


def test_raw_bitpack_smaller_on_small_values(rng):
    x = rng.integers(0, 8, 10000).astype(np.uint8)  # 3-bit values
    buf = compress_simple(x, 8, "raw")
    assert len(buf) < 6000  # ~3-4 bits/elem incl. headers


# ---------------------------------------------------------------- oracle
# Byte-exactness for the non-RLE codecs (VERDICT r3 item 4: PARITY rows
# 2/6b previously claimed byte-exactness with only round-trip backing).
import itertools

import oracle

oracle_only = pytest.mark.skipif(
    not oracle.available(), reason="reference oracle library not built")


@oracle_only
@pytest.mark.parametrize("codec,elem_sz", itertools.product(
    ["raw", "delta"], [1, 2]))
def test_simple_byte_exact(rng, codec, elem_sz):
    refname = f"compress_{codec}_{8 * elem_sz}b"
    for ndims in [1, 4, 5, 8, 17, 33, 64]:
        for sz in [1, 127, 128, 129, 512, 1000]:
            for kind in KINDS:
                x = make_stream(rng, sz * ndims, elem_sz, kind)
                mine = compress_simple(x, ndims, codec)
                ref = oracle.ref_compress_simple(refname, x, ndims)
                oracle.assert_stream_matches(
                    mine, ref,
                    f"simple {codec} {elem_sz}b ndims={ndims} sz={sz} {kind}")


@oracle_only
@pytest.mark.parametrize("codec,elem_sz", itertools.product(
    ["raw", "delta"], [1, 2]))
def test_simple_cross_decode(rng, codec, elem_sz):
    for ndims in [1, 5, 17, 64]:
        for sz in [129, 1000]:
            x = make_stream(rng, sz * ndims, elem_sz, "rand")
            mine = compress_simple(x, ndims, codec)
            ref_out = oracle.ref_decompress_simple(
                f"decompress_{codec}_{8 * elem_sz}b", mine, x.size)
            np.testing.assert_array_equal(ref_out, x)
            ref_buf, _ = oracle.ref_compress_simple(
                f"compress_{codec}_{8 * elem_sz}b", x, ndims)
            np.testing.assert_array_equal(
                decompress_simple(ref_buf, codec, elem_sz=elem_sz), x)


@oracle_only
def test_xff_plain_byte_exact(rng):
    """compress_simple('xff') vs compress8b_rowmajor_xff
    (sprintz_xff.cpp:34-628 — the reference builds it u8-only)."""
    for ndims in [1, 4, 8, 17, 33, 64]:
        for sz in [1, 127, 128, 129, 512, 1000]:
            for kind in KINDS:
                x = make_stream(rng, sz * ndims, 1, kind)
                mine = compress_simple(x, ndims, "xff")
                ref = oracle.ref_xff_plain_compress(x, ndims)
                assert mine == ref, (
                    f"xff plain ndims={ndims} sz={sz} {kind}: "
                    f"len {len(mine)} vs {len(ref)}, first diff "
                    f"{next((i for i in range(min(len(mine), len(ref))) if mine[i] != ref[i]), -1)}")
                np.testing.assert_array_equal(
                    oracle.ref_xff_plain_decompress(mine, x.size), x)
                np.testing.assert_array_equal(
                    decompress_simple(ref, "xff", elem_sz=1), x)
