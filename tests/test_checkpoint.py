"""Seekable streams: sidecar capture + mid-stream decode (jump() analogue)."""

import numpy as np
import pytest

from sprintz_jax.checkpoint import (
    Sidecar,
    compress_with_sidecar,
    decode_range,
    decompress_parallel,
)

from conftest import make_stream


@pytest.mark.parametrize("codec", ["delta", "xff"])
def test_decode_range_matches_full(rng, codec):
    D = 9
    nrows = 5000
    rows = make_stream(rng, nrows * D, 1, "sparse").reshape(nrows, D)
    stream, sc = compress_with_sidecar(
        rows.reshape(-1), D, codec=codec, every_groups=16)
    sc = Sidecar.from_bytes(sc.to_bytes())  # serialization round trip
    for start, n in [(0, 64), (997, 400), (2500, 1000), (4800, 150)]:
        got = decode_range(stream, sc, start, n)
        exp = rows[start : start + n]
        np.testing.assert_array_equal(got[: len(exp)], exp)


def test_stream_is_byte_exact_with_sidecar(rng):
    from sprintz_jax import encoder

    x = make_stream(rng, 3000, 1, "small")
    stream, _ = compress_with_sidecar(x, 1, codec="delta")
    # building a sidecar must not change the stream bytes...
    # (ndims=1 dispatches to lowdim in the plain API; force rowmajor both)
    assert stream == encoder.compress(x, 1, codec="delta")


@pytest.mark.parametrize("codec", ["delta", "xff"])
@pytest.mark.parametrize("elem_sz", [1, 2])
@pytest.mark.parametrize("kind", ["rand", "sparse", "zeros"])
def test_decompress_parallel_one_pass(rng, codec, elem_sz, kind):
    """decompress_parallel == serial decompress == input, for rowmajor
    streams with and without RLE runs (vmapped _decode_pass_chunks)."""
    from sprintz_jax import decoder

    D = 24
    nrows = 3000
    flat = make_stream(rng, nrows * D, elem_sz, kind)
    stream, sc = compress_with_sidecar(flat, D, codec=codec,
                                       every_groups=16)
    got = decompress_parallel(stream, sc)
    np.testing.assert_array_equal(got, flat)
    np.testing.assert_array_equal(
        got, decoder.decompress(stream, codec, elem_sz))


@pytest.mark.parametrize("codec", ["delta", "xff"])
@pytest.mark.parametrize("ndims,elem_sz", [(3, 1), (2, 2), (1, 1)])
def test_decompress_parallel_lowdim(rng, codec, ndims, elem_sz):
    flat = make_stream(rng, 2048 * ndims, elem_sz, "sparse")
    stream, sc = compress_with_sidecar(flat, ndims, codec=codec,
                                       every_groups=8)
    np.testing.assert_array_equal(decompress_parallel(stream, sc), flat)


def test_decompress_parallel_tiny_and_single_chunk(rng):
    # verbatim stream (len < 128) and a single-checkpoint stream both
    # take the serial fallback
    for n in (64, 400):
        flat = make_stream(rng, n, 1, "rand")
        stream, sc = compress_with_sidecar(flat, 1, codec="delta",
                                           every_groups=1024)
        np.testing.assert_array_equal(decompress_parallel(stream, sc), flat)


def test_api_seekable_roundtrip(rng):
    from sprintz_jax.api import SprintzCodec

    cd = SprintzCodec(codec="xff", elem_sz=2)
    data = make_stream(rng, 4000 * 12, 2, "sparse").reshape(4000, 12)
    stream, sc = cd.compress_seekable(data)
    assert stream == cd.compress(data)
    np.testing.assert_array_equal(
        cd.decompress(stream, sidecar=sc), data.reshape(-1))
    # with the entropy stage on top
    ch = SprintzCodec(codec="xff", elem_sz=2, entropy="huffman")
    hstream, hsc = ch.compress_seekable(data)
    np.testing.assert_array_equal(
        ch.decompress(hstream, sidecar=hsc), data.reshape(-1))


def test_chunk_parallel_decode(rng):
    # several workers each decode their own range; concatenation == full
    codec = "xff"
    D = 4
    nrows = 4096
    rows = make_stream(rng, nrows * D, 1, "sparse").reshape(nrows, D)
    stream, sc = compress_with_sidecar(
        rows.reshape(-1), D, codec=codec, every_groups=8)
    chunk = 1024
    parts = [decode_range(stream, sc, s, chunk)
             for s in range(0, nrows, chunk)]
    got = np.concatenate([p[:chunk] for p in parts])
    np.testing.assert_array_equal(got[:nrows], rows)


def test_decompress_parallel_rejects_bad_sidecar(rng):
    from sprintz_jax.errors import CorruptStreamError

    flat = make_stream(rng, 4000 * 8, 1, "sparse")
    stream, sc = compress_with_sidecar(flat, 8, codec="delta",
                                       every_groups=16)
    bad = Sidecar.from_bytes(sc.to_bytes())
    bad.row_offsets = bad.row_offsets[::-1].copy()
    with pytest.raises(CorruptStreamError):
        decompress_parallel(stream, bad)
