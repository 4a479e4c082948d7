"""Online subsystem: predictor invertibility, dynamic choice, sprintzpack.

Mirrors test_online.cpp's strategy (invertibility + semantic sanity) and
adds oracle byte-exactness when the reference library is available.
"""

import numpy as np
import pytest

from sprintz_jax.models import online as ol

import oracle


def _streams(rng):
    yield rng.integers(0, 65536, 1000).astype(np.uint16)
    yield (np.cumsum(rng.integers(-5, 6, 2000)) & 0xFFFF).astype(np.uint16)
    yield np.zeros(500, np.uint16)
    yield (np.arange(777) * 3 % 1000).astype(np.uint16)
    yield rng.integers(0, 65536, 1).astype(np.uint16)
    yield np.zeros(0, np.uint16)


@pytest.mark.parametrize("cls", [
    ol.DeltaPredictor, ol.DoubleDeltaPredictor, ol.TripleDeltaPredictor,
    ol.MovingAvgPredictor])
def test_predictive_coding_invertible(rng, cls):
    for x in _streams(rng):
        errs = ol.predictive_encode(x, cls)
        np.testing.assert_array_equal(ol.predictive_decode(errs, cls), x)


def test_delta_predictor_actually_delta_codes(rng):
    # semantic sanity (test_online.cpp:37-80)
    x = rng.integers(0, 65536, 100).astype(np.uint16)
    errs = ol.predictive_encode(x, ol.DeltaPredictor)
    expected = (x.astype(np.int64)
                - np.concatenate([[0], x[:-1]]).astype(np.int64))
    np.testing.assert_array_equal(
        errs[1:], (expected[1:] & 0xFFFF).astype(np.uint16).view(np.int16))


@pytest.mark.parametrize("order,cls", [
    (1, ol.DeltaPredictor), (2, ol.DoubleDeltaPredictor),
    (3, ol.TripleDeltaPredictor)])
def test_vectorized_matches_scalar(rng, order, cls):
    for n in [0, 1, 2, 9, 500]:
        x = rng.integers(0, 65536, n).astype(np.uint16)
        np.testing.assert_array_equal(
            ol.predictive_encode(x, cls), ol.nth_order_delta_encode(x, order))
        np.testing.assert_array_equal(
            ol.nth_order_delta_decode(ol.nth_order_delta_encode(x, order),
                                      order), x)


@pytest.mark.parametrize("loss", [ol.LOSS_MAX_ABS, ol.LOSS_SUM_LOG_ABS])
def test_dynamic_delta_roundtrip(rng, loss):
    for x in _streams(rng):
        buf = ol.dynamic_delta_pack_u16(x, loss)
        np.testing.assert_array_equal(ol.dynamic_delta_unpack_u16(buf), x)


@pytest.mark.parametrize("zigzag", [False, True])
def test_sprintzpack_roundtrip(rng, zigzag):
    for x in _streams(rng):
        buf = ol.sprintzpack_pack_u16(x, zigzag=zigzag)
        np.testing.assert_array_equal(
            ol.sprintzpack_unpack_u16(buf, zigzag=zigzag), x)


def test_zigzag_pack_roundtrip(rng):
    for x in _streams(rng):
        np.testing.assert_array_equal(
            ol.zigzag_unpack_u16(ol.zigzag_pack_u16(x)), x)


@pytest.mark.skipif(not oracle.available(), reason="oracle not built")
def test_online_formats_byte_exact(rng):
    import ctypes

    lib = ctypes.CDLL(oracle._LIB_PATH)

    def ref_pack(sym, data):
        fn = getattr(lib, sym)
        fn.restype = ctypes.c_uint32
        out = np.zeros(data.size * 4 + 64, dtype=np.int16)
        n = fn(data.ctypes.data_as(ctypes.c_void_p),
               ctypes.c_size_t(data.size),
               out.ctypes.data_as(ctypes.c_void_p))
        return out[:n].tobytes()

    for x in _streams(rng):
        if x.size == 0:
            continue
        cases = [
            (ol.sprintzpack_pack_u16(x, zigzag=False),
             ref_pack("_Z20sprintzpack_pack_u16PKtmPs", x)),
            (ol.sprintzpack_pack_u16(x, zigzag=True),
             ref_pack("_Z27sprintzpack_pack_u16_zigzagPKtmPs", x)),
            (ol.dynamic_delta_pack_u16(x, ol.LOSS_SUM_LOG_ABS),
             ref_pack("_Z22dynamic_delta_pack_u16PKtmPs", x)),
            (ol.dynamic_delta_pack_u16(x, ol.LOSS_MAX_ABS),
             ref_pack("_Z30dynamic_delta_pack_u16_altlossPKtmPs", x)),
            (ol.zigzag_pack_u16(x),
             ref_pack("_Z15zigzag_pack_u16PKtmPs", x)),
        ]
        for mine, ref in cases:
            assert mine == ref[: len(mine)]
            assert 0 <= len(ref) - len(mine) <= 1  # u16-unit length rounding
