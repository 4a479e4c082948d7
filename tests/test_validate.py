"""Stream validator: accepts valid streams, pinpoints corruption."""

import numpy as np

from sprintz_jax import encoder
from sprintz_jax.validate import validate_stream

from conftest import make_stream


def test_valid_streams_pass(rng):
    for codec in ("delta", "xff"):
        for ndims in (1, 9):
            x = make_stream(rng, 600 * ndims, 1, "sparse")
            buf = encoder.compress(x, ndims, codec=codec)
            rep = validate_stream(buf)
            assert rep.ok, rep.errors
            assert rep.total_rows * ndims + _tail(buf) == x.size


def _tail(buf):
    from sprintz_jax.golden.stream import read_metadata_rle

    return read_metadata_rle(buf)[1]


def test_truncation_detected(rng):
    x = make_stream(rng, 4000, 1, "rand")
    buf = encoder.compress(x, 8, codec="delta")
    for cut in (4, 9, len(buf) // 2, len(buf) - 1):
        rep = validate_stream(buf[:cut])
        assert not rep.ok
        assert rep.errors


def test_garbage_metadata():
    rep = validate_stream(b"\xff" * 64)
    assert not rep.ok
