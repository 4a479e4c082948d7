"""Long-stream conformance at reference scale (JAX backend).

The reference grid runs sizes up to 4096 plus a 1M+7-element fuzz
(cpp/Compress/test/compress_testing.hpp:467-477). Round 1's JAX tests
capped at 500 rows, which hid a decode-precision bug that only appeared
past the hierarchical-cumsum chunk size (512 rows) on an accelerator:
default-precision matmuls may round f32 inputs (bf16, or TF32 on a GPU),
corrupting sums of full-magnitude u16 deltas. The fixed formulation
decomposes into byte planes with *explicit* bf16 (or s8) casts, so these
CPU tests exercise the identical numerics the device sees.
"""

import numpy as np
import pytest

from sprintz_jax import decoder, encoder

from conftest import make_stream

# (codec, elem_sz, ndims, n_elems) — rowmajor and lowdim, both codecs,
# with u16/rand (full-magnitude deltas) covering the round-1 bug path.
CASES = [
    ("delta", 2, 8, 4096),
    ("delta", 2, 8, 1_000_007),  # the reference's 1M+7 fuzz size
    ("delta", 2, 2, 300_000),    # u16 lowdim
    ("delta", 1, 16, 1_000_007),
    ("xff", 2, 8, 300_000),
    ("xff", 2, 2, 120_000),      # u16 lowdim xff
    ("xff", 1, 4, 300_000),      # u8 lowdim xff
    ("xff", 1, 64, 300_000),
]


@pytest.mark.parametrize("codec,elem_sz,ndims,n", CASES)
def test_longstream_roundtrip(rng, codec, elem_sz, ndims, n):
    for kind in ("rand", "small"):
        x = make_stream(rng, n, elem_sz, kind)
        buf = encoder.compress(x, ndims, codec=codec)
        out = decoder.decompress(buf, codec=codec, elem_sz=elem_sz)
        np.testing.assert_array_equal(out, x, err_msg=f"{kind}")


def test_cumsum_adversarial_magnitudes(rng):
    """Full-magnitude i16 deltas through the MXU prefix sum, every chunk
    boundary crossed — the exact failure mode of round-1 weak #1."""
    import jax.numpy as jnp

    from sprintz_jax.models.forecasters import hierarchical_cumsum

    for shape in [(513, 3), (5000, 17), (4096, 1), (2000,)]:
        x = rng.integers(-32768, 32768, shape).astype(np.int32)
        got = np.asarray(hierarchical_cumsum(jnp.asarray(x), value_bits=16))
        np.testing.assert_array_equal(got, np.cumsum(x, axis=0, dtype=np.int32))
    # extreme constant input: worst-case partial-sum magnitude
    x = np.full((4096, 4), -32768, np.int32)
    got = np.asarray(hierarchical_cumsum(jnp.asarray(x), value_bits=16))
    np.testing.assert_array_equal(got, np.cumsum(x, axis=0, dtype=np.int32))


@pytest.mark.parametrize("codec,elem_sz", [("delta", 2), ("xff", 1)])
def test_chunked_decode_matches_single_pass(rng, codec, elem_sz, monkeypatch):
    """Tiled decode (forecaster state carried across tiles) must be
    bit-identical to the single-pass path."""
    from sprintz_jax import decoder as dec

    x = make_stream(rng, 200_000, elem_sz, "rand")
    buf = encoder.compress(x, 8, codec=codec)
    want = dec.decompress(buf, codec=codec, elem_sz=elem_sz)
    monkeypatch.setattr(dec, "CHUNK_OUT_BYTES", 1 << 16)  # force ~12 tiles
    got = dec.decompress(buf, codec=codec, elem_sz=elem_sz)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("lowdim_pass", ["legacy", "dmajor", "grouped"])
def test_chunked_lowdim_passes_state_carry(rng, lowdim_pass, monkeypatch):
    """Every lowdim delta pass must carry tile state identically."""
    import jax

    from sprintz_jax import decoder as dec

    x = (np.cumsum(rng.integers(-7, 8, 100_000 * 4)) % 256).astype(np.uint8)
    buf = encoder.compress(x, 4, codec="delta")
    monkeypatch.setattr(dec, "LOWDIM_PASS", lowdim_pass)
    monkeypatch.setattr(dec, "CHUNK_OUT_BYTES", 1 << 16)
    jax.clear_caches()
    try:
        got = dec.decompress(buf, codec="delta", elem_sz=1)
    finally:
        jax.clear_caches()
    np.testing.assert_array_equal(got, x)
