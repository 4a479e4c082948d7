"""Golden codec conformance: round-trip grid over sizes x ndims x families.

Mirrors the reference's property-test style (test/compress_testing.hpp):
round-trip equality over a grid of sizes, dims and input families,
including RLE-heavy inputs and the lowdim/rowmajor dispatch boundary.
"""

import numpy as np
import pytest

from sprintz_jax import api
from sprintz_jax.golden.lowdim import compress_lowdim_rle, decompress_lowdim_rle
from sprintz_jax.golden.rowmajor import (
    compress_rowmajor_rle,
    decompress_rowmajor_rle,
    read_metadata_rle,
)

from conftest import KINDS, make_stream

SIZES = [1, 7, 16, 127, 128, 129, 136, 512, 1000]
CODECS = ["delta", "xff"]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("elem_sz", [1, 2])
@pytest.mark.parametrize("ndims", [1, 2, 4, 5, 8, 17, 33])
def test_rowmajor_roundtrip(rng, codec, elem_sz, ndims):
    for sz in SIZES:
        for kind in KINDS:
            x = make_stream(rng, sz * ndims, elem_sz, kind)
            comp = compress_rowmajor_rle(x, ndims, codec=codec)
            dec = decompress_rowmajor_rle(comp, codec=codec, elem_sz=elem_sz)
            np.testing.assert_array_equal(dec, x)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("elem_sz,ndims", [(1, 1), (1, 2), (1, 3), (1, 4),
                                           (2, 1), (2, 2)])
def test_lowdim_roundtrip(rng, codec, elem_sz, ndims):
    for sz in SIZES:
        for kind in KINDS:
            x = make_stream(rng, sz * ndims, elem_sz, kind)
            comp = compress_lowdim_rle(x, ndims, codec=codec)
            dec = decompress_lowdim_rle(comp, codec=codec, elem_sz=elem_sz)
            np.testing.assert_array_equal(dec, x)


@pytest.mark.parametrize("codec", CODECS)
def test_api_dispatch_roundtrip(rng, codec):
    for elem_sz in (1, 2):
        for ndims in (1, 3, 5, 16):
            sc = api.SprintzCodec(codec, elem_sz, backend="golden")
            x = make_stream(rng, 300 * ndims, elem_sz, "sparse").reshape(300, ndims)
            dec = sc.decompress(sc.compress(x))
            np.testing.assert_array_equal(dec, x.reshape(-1))


def test_metadata_layout():
    x = np.arange(50, dtype=np.uint8)  # below MIN_DATA_SIZE -> verbatim
    comp = compress_rowmajor_rle(x, 1)
    ngroups, remaining, ndims = read_metadata_rle(comp)
    assert (ngroups, remaining, ndims) == (0, 50, 1)
    assert comp[8:] == x.tobytes()


def test_run_cap(rng):
    # > 0x7fff zero blocks in a row forces the 15-bit run counter to cap
    # and re-enter RLE (sprintz_delta_rle.cpp:308).
    n = (0x7FFF + 10) * 8 + 128
    x = np.zeros(n, dtype=np.uint8)
    x[-64:] = rng.integers(1, 255, 64).astype(np.uint8)
    comp = compress_rowmajor_rle(x, 1, codec="delta")
    assert len(comp) < 200  # massive compression
    dec = decompress_rowmajor_rle(comp, codec="delta", elem_sz=1)
    np.testing.assert_array_equal(dec, x)


def test_compression_ratio_sanity(rng):
    # slowly-varying univariate data: +/-2 deltas need 3 bits, and the
    # dispatch must route ndims=1 to the unpadded column-major codec
    x = (np.cumsum(rng.integers(-2, 3, 100_000)) % 256).astype(np.uint8)
    comp = api.SprintzCodec("delta", 1, backend="golden").compress(x)
    assert len(comp) < 52_000  # ~3.75 bits/elem incl. headers


def test_custom_codec_config(rng):
    # non-default block/group sizes give self-consistent streams
    from sprintz_jax.constants import CodecConfig
    from sprintz_jax.golden.stream import (
        LowDimLayout, RowMajorLayout, compress_rle, decompress_rle)

    for cfg in (CodecConfig(block_sz=16, group_sz_blocks=4),
                CodecConfig(block_sz=8, group_sz_blocks=8),
                CodecConfig(max_run_nblocks=3)):
        for layout, ndims in ((RowMajorLayout, 5), (LowDimLayout, 2)):
            x = make_stream(rng, 900 * ndims, 1, "sparse")
            buf = compress_rle(x, ndims, "delta", layout, cfg=cfg)
            dec = decompress_rle(buf, "delta", layout, elem_sz=1, cfg=cfg)
            np.testing.assert_array_equal(dec, x)
        # default cfg must keep reference compatibility
    default = compress_rle(make_stream(rng, 1000, 1, "sparse"), 1, "delta",
                           LowDimLayout)
    assert isinstance(default, bytes)
