"""ndims conformance sweep (the reference's test_codec_many_ndims analogue,
test/compress_testing.hpp:482-496, reduced for CI time)."""

import numpy as np
import pytest

from sprintz_jax import decoder, encoder

from conftest import make_stream

NDIMS_SWEEP = list(range(1, 18)) + [31, 32, 33, 63, 64, 65, 127, 128, 129]


# parameterized per-ndims so pytest-xdist can spread the work: as one
# test the xff sweep was a 281 s straggler that set the whole suite's
# critical path
@pytest.mark.parametrize("ndims", NDIMS_SWEEP)
@pytest.mark.parametrize("codec", ["delta", "xff"])
def test_ndims_sweep_roundtrip(rng, codec, ndims):
    x = make_stream(rng, 160 * ndims, 1, "sparse")
    buf = encoder.compress(x, ndims, codec=codec)
    dec = decoder.decompress(buf, codec=codec, elem_sz=1)
    np.testing.assert_array_equal(dec, x, err_msg=f"ndims={ndims}")


def test_ndims_sweep_byte_exact(rng):
    import oracle

    if not oracle.available():
        pytest.skip("oracle not built")
    for codec in ("delta", "xff"):
        for ndims in [5, 33, 65, 129]:
            x = make_stream(rng, 200 * ndims, 1, "sparse")
            mine = encoder.compress(x, ndims, codec=codec)
            ref = oracle.ref_compress(f"compress_{codec}_rle_8b", x, ndims)
            oracle.assert_stream_matches(mine, ref, f"{codec} d={ndims}")


# --- full-width conformance: every ndims the reference dispatch accepts ---
#
# The reference's de-facto format conformance suite runs its whole grid for
# every ndims in 1..129 (test/compress_testing.hpp:20-21,482-496). This is
# the byte-exact analogue: the API-level golden codec (which reproduces the
# sprintz.cpp:34-74 lowdim/rowmajor dispatch) against the API-level oracle
# entry points, over the reference's size grid (:467-477, trimmed of
# adjacent duplicates) x input families.

FULL_SIZES = [1, 2, 7, 8, 63, 64, 66, 127, 128, 129, 135, 136, 137,
              4096, 4113]
_KINDS_ROT = ["rand", "small", "ramp", "zeros"]


@pytest.mark.parametrize("ndims", range(1, 130))
@pytest.mark.parametrize("codec,elem_sz",
                         [("delta", 1), ("delta", 2),
                          ("xff", 1), ("xff", 2)])
def test_full_ndims_oracle_conformance(rng, codec, elem_sz, ndims):
    import oracle

    if not oracle.available():
        pytest.skip("oracle not built")
    from sprintz_jax.api import SprintzCodec

    refname = f"sprintz_compress_{codec}_{8 * elem_sz}b"
    mine = SprintzCodec(codec, elem_sz, backend="golden")
    for i, sz in enumerate(FULL_SIZES):
        # sparse always (exercises RLE runs) + one rotating family
        for kind in ("sparse", _KINDS_ROT[(ndims + i) % len(_KINDS_ROT)]):
            x = make_stream(rng, sz, elem_sz, kind)
            buf = mine.compress(x, ndims=ndims)
            ref = oracle.ref_compress(refname, x, ndims)
            oracle.assert_stream_matches(
                buf, ref, f"{codec} {8 * elem_sz}b d={ndims} n={sz} {kind}")
            # and the stream decodes back (golden decoder, same dispatch)
            np.testing.assert_array_equal(
                mine.decompress(buf), x,
                err_msg=f"{codec} {8 * elem_sz}b d={ndims} n={sz} {kind}")
