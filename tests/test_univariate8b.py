"""Legacy dyndelta 8-bit byte format: oracle byte-exactness + round trips
(univariate_8b.cpp:1523-1677)."""

import numpy as np
import pytest

import oracle
from sprintz_jax.golden.univariate8b import (
    compress_dyndelta_8b, decompress_dyndelta_8b)
from sprintz_jax.univariate import compress_univariate, decompress_univariate

from conftest import make_stream

SIZES = [0, 1, 63, 64, 65, 128, 1000, 4096, 4099]


def test_dyndelta_roundtrip(rng):
    for n in SIZES:
        for kind in ("rand", "small", "zeros", "sparse", "ramp"):
            x = make_stream(rng, n, 1, kind)
            buf = compress_dyndelta_8b(x)
            np.testing.assert_array_equal(decompress_dyndelta_8b(buf), x,
                                          err_msg=f"{n}/{kind}")


@pytest.mark.skipif(not oracle.available(), reason="oracle not built")
def test_dyndelta_byte_exact(rng):
    for n in SIZES:
        for kind in ("rand", "small", "zeros", "sparse", "ramp"):
            x = make_stream(rng, n, 1, kind)
            mine = compress_dyndelta_8b(x)
            ref = oracle.ref_dyndelta_compress(x)
            assert mine == ref, f"{n}/{kind}"
            # cross-decode both ways
            np.testing.assert_array_equal(
                oracle.ref_dyndelta_decompress(mine, n), x)
            np.testing.assert_array_equal(decompress_dyndelta_8b(ref), x)


def test_dyndelta_facade(rng):
    x = make_stream(rng, 2000, 1, "small")
    buf = compress_univariate(x, method="dyndelta8b")
    np.testing.assert_array_equal(
        decompress_univariate(buf, method="dyndelta8b"), x)


def test_dyndelta_picks_doubledelta_on_ramps():
    # a steady ramp has constant delta -> double-delta all zeros; the
    # choice bit must fire and the stream must shrink accordingly
    x = (np.arange(6400) % 256).astype(np.uint8)
    buf = compress_dyndelta_8b(x)
    assert len(buf) < 8 + 4 * (6400 // 64) + 6400 // 8
    np.testing.assert_array_equal(decompress_dyndelta_8b(buf), x)


@pytest.mark.skipif(not oracle.available(), reason="oracle not built")
def test_delta_doubledelta_byte_exact(rng):
    from sprintz_jax.golden import univariate8b as u8b

    pairs = {
        "delta8b": (u8b.compress_delta_8b, u8b.decompress_delta_8b),
        "doubledelta8b": (u8b.compress_doubledelta_8b,
                          u8b.decompress_doubledelta_8b),
    }
    for name, (enc, dec) in pairs.items():
        for n in [0, 1, 7, 8, 9, 63, 64, 71, 73, 1000, 4099]:
            for kind in ("rand", "small", "zeros", "ramp"):
                x = make_stream(rng, n, 1, kind)
                mine = enc(x)
                assert mine == oracle.ref_univariate_compress(name, x), \
                    f"{name}/{n}/{kind}"
                np.testing.assert_array_equal(dec(mine), x)
                np.testing.assert_array_equal(
                    oracle.ref_univariate_decompress(name, mine, n), x)


def test_legacy_facade_roundtrips(rng):
    x = make_stream(rng, 3000, 1, "small")
    for m in ("delta8b", "doubledelta8b", "dyndelta8b"):
        buf = compress_univariate(x, method=m)
        np.testing.assert_array_equal(
            decompress_univariate(buf, method=m), x, err_msg=m)


@pytest.mark.skipif(not oracle.available(), reason="oracle not built")
def test_delta_simple_rle_byte_exact(rng):
    from sprintz_jax.golden import univariate8b as u8b

    for n in [0, 1, 15, 16, 17, 63, 64, 65, 1000, 4099, 50_000]:
        for kind in ("rand", "small", "zeros", "sparse", "ramp"):
            x = make_stream(rng, n, 1, kind)
            mine = u8b.compress_delta_simple_8b(x)
            assert mine == oracle.ref_univariate_compress(
                "delta_simple8b", x), f"simple/{n}/{kind}"
            np.testing.assert_array_equal(
                u8b.decompress_delta_simple_8b(mine), x)
            mine = u8b.compress_delta_rle_8b(x)
            assert mine == oracle.ref_univariate_compress(
                "delta_rle8b", x), f"rle/{n}/{kind}"
            np.testing.assert_array_equal(
                u8b.decompress_delta_rle_8b(mine), x)
            np.testing.assert_array_equal(
                oracle.ref_univariate_decompress("delta_rle8b", mine, n), x)


ALL_NINE = ["delta_simple8b", "delta8b", "online8b", "delta_online8b",
            "delta2_online8b", "delta_rle8b", "delta_rle28b",
            "doubledelta8b", "dyndelta8b"]


@pytest.mark.skipif(not oracle.available(), reason="oracle not built")
def test_all_nine_byte_exact(rng):
    """Every legacy univariate codec's encoder matches the reference
    byte-for-byte (decoders: self round-trip always; reference
    cross-decode where the reference's decoder isn't its documented
    speed-hack)."""
    from sprintz_jax.golden import univariate8b as u8b

    enc_dec = {
        "delta_simple8b": (u8b.compress_delta_simple_8b,
                           u8b.decompress_delta_simple_8b),
        "delta8b": (u8b.compress_delta_8b, u8b.decompress_delta_8b),
        "online8b": (u8b.compress_online_8b, u8b.decompress_online_8b),
        "delta_online8b": (u8b.compress_delta_online_8b,
                           u8b.decompress_delta_online_8b),
        "delta2_online8b": (u8b.compress_delta2_online_8b,
                            u8b.decompress_delta2_online_8b),
        "delta_rle8b": (u8b.compress_delta_rle_8b,
                        u8b.decompress_delta_rle_8b),
        "delta_rle28b": (u8b.compress_delta_rle2_8b,
                         u8b.decompress_delta_rle2_8b),
        "doubledelta8b": (u8b.compress_doubledelta_8b,
                          u8b.decompress_doubledelta_8b),
        "dyndelta8b": (u8b.compress_dyndelta_8b,
                       u8b.decompress_dyndelta_8b),
    }
    for name in ALL_NINE:
        enc, dec = enc_dec[name]
        for n in [0, 1, 16, 64, 65, 1000, 4099]:
            for kind in ("rand", "small", "zeros", "sparse"):
                x = make_stream(rng, n, 1, kind)
                mine = enc(x)
                assert mine == oracle.ref_univariate_compress(name, x), \
                    f"{name}/{n}/{kind}"
                np.testing.assert_array_equal(dec(mine), x,
                                              err_msg=f"{name}/{n}/{kind}")
                if oracle._UNIVARIATE_SYMBOLS[name][1]:
                    np.testing.assert_array_equal(
                        oracle.ref_univariate_decompress(name, mine, n), x)


def test_all_nine_facade(rng):
    x = make_stream(rng, 2000, 1, "small")
    for m in ALL_NINE:
        buf = compress_univariate(x, method=m)
        np.testing.assert_array_equal(
            decompress_univariate(buf, method=m), x, err_msg=m)
