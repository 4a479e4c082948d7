"""Standalone preprocessor transforms (delta.cpp / predict.cpp parity).

Round-trip tests always run; byte-exactness vs the compiled reference
runs when the oracle library is present (VERDICT r3 item 8 — including
the xff preprocessor's divergent learning_shift and the in-place decode
entry points).
"""

import itertools

import numpy as np
import pytest

import oracle
from sprintz_jax.transforms import (
    KINDS,
    transform_decode,
    transform_decode_inplace,
    transform_encode,
)

from conftest import KINDS as STREAM_KINDS, make_stream

SIZES = [1, 7, 64, 127, 128, 129, 1000, 4096]


@pytest.mark.parametrize("kind,elem_sz", itertools.product(KINDS, [1, 2]))
def test_transform_roundtrip(rng, kind, elem_sz):
    for ndims in [1, 3, 12, 17, 33, 40]:
        for sz in SIZES:
            x = make_stream(rng, sz, elem_sz, "rand")
            buf = transform_encode(x, kind, ndims=ndims)
            out = transform_decode(buf, kind, elem_sz)
            np.testing.assert_array_equal(out, x, err_msg=(
                f"{kind} u{8*elem_sz} ndims={ndims} sz={sz}"))


def test_transform_inplace(rng):
    x = make_stream(rng, 1000, 1, "rand")
    body = np.frombuffer(
        transform_encode(x, "xff", ndims=8, write_size=False), np.uint8)
    buff = np.concatenate([body, np.zeros(64, np.uint8)])
    out = transform_decode_inplace(buff, x.size, 8, "xff")
    np.testing.assert_array_equal(out, x)


def test_transform_validation(rng):
    with pytest.raises(ValueError):
        transform_encode(np.zeros(8, np.uint8), "nope")
    with pytest.raises(TypeError):
        transform_encode(np.zeros(8, np.int32), "delta")


oracle_only = pytest.mark.skipif(
    not oracle.available(), reason="reference oracle library not built")


@oracle_only
@pytest.mark.parametrize("kind,elem_sz", itertools.product(KINDS, [1, 2]))
def test_transform_encode_byte_exact(rng, kind, elem_sz):
    for ndims in [1, 3, 12, 17, 32, 33, 40]:
        for sz in SIZES:
            for sk in STREAM_KINDS:
                x = make_stream(rng, sz, elem_sz, sk)
                mine = transform_encode(x, kind, ndims=ndims)
                ref = oracle.ref_transform_encode(kind, x, ndims)
                assert mine == ref, (
                    f"{kind} u{8*elem_sz} ndims={ndims} sz={sz} {sk}: "
                    "first diff at "
                    f"{next(i for i in range(min(len(mine), len(ref))) if mine[i] != ref[i])}"
                    if mine[:min(len(mine), len(ref))] != ref[:min(len(mine), len(ref))]
                    else f"{kind} length {len(mine)} vs {len(ref)}")


@oracle_only
@pytest.mark.parametrize("kind,elem_sz", itertools.product(KINDS, [1, 2]))
def test_transform_cross_decode(rng, kind, elem_sz):
    """Our decode reads reference streams; the reference decodes ours
    (both the 4-arg and the in-place entry points)."""
    for ndims in [1, 5, 17, 40]:
        for sz in [129, 1000]:
            x = make_stream(rng, sz, elem_sz, "rand")
            ref_buf = oracle.ref_transform_encode(kind, x, ndims)
            np.testing.assert_array_equal(
                transform_decode(ref_buf, kind, elem_sz), x,
                err_msg=f"ours<-ref {kind} {elem_sz} d{ndims} n{sz}")
            mine = transform_encode(x, kind, ndims=ndims)
            np.testing.assert_array_equal(
                oracle.ref_transform_decode(kind, elem_sz, mine, x.size), x,
                err_msg=f"ref<-ours {kind} {elem_sz} d{ndims} n{sz}")
            body = np.frombuffer(mine[6:], np.uint8).view(
                np.uint8 if elem_sz == 1 else np.uint16)
            np.testing.assert_array_equal(
                oracle.ref_transform_decode_inplace(
                    kind, elem_sz, body, x.size, ndims), x,
                err_msg=f"ref-inplace<-ours {kind} {elem_sz} d{ndims} n{sz}")
