"""Round-5 unpack formulation variants: byte-window count + bf3.

Two levers aimed at the roofline-pinned VPU wall (the one-hot weight
BUILD of the rowmajor unpack, STATUS "Round-5 roofline accounting"):

- ``UNPACK_NWIN`` auto: u8 fields stop at (off & 7) + width <= 15 bits,
  so the third (65536) byte window is provably zero — two windows
  suffice, dropping one compare+select level from the weight build and
  one matmul from the pack.
- ``MXU_IMPL="bf3"``: the shifted-payload formulation — ONE {0,1}
  byte-select one-hot (a single compare) with byte-shifted payload
  copies riding the same dot's M axis; chunk_s8's structure with bf16
  carriers.

Every variant must be bit-identical to the production bf16/3-window
path on the raw (un)pack, the full decode passes (contiguous, runs,
folded), and the encoder's emitted bytes.
"""

import jax
import numpy as np
import pytest

import sprintz_jax.ops.pack as pack
from sprintz_jax.ops.bitmath import block_widths_rowmajor


@pytest.fixture(params=["bf16", "bf3"])
def mxu_impl(request):
    prev = pack.MXU_IMPL
    pack.MXU_IMPL = request.param
    jax.clear_caches()
    yield request.param
    pack.MXU_IMPL = prev
    jax.clear_caches()


@pytest.fixture(params=["auto", "2", "3"])
def nwin(request):
    prev = pack.UNPACK_NWIN
    pack.UNPACK_NWIN = request.param
    jax.clear_caches()
    yield request.param
    pack.UNPACK_NWIN = prev
    jax.clear_caches()


@pytest.mark.parametrize("ndims,elem_sz", [(64, 1), (17, 1), (40, 2),
                                           (5, 1)])
def test_unpack_variants_roundtrip(rng, mxu_impl, nwin, ndims, elem_sz):
    """Raw pack -> unpack under every (impl, nwin) pair, full widths.

    A forced "2" on a u16 stream must CLAMP to 3 windows (2 can never
    be valid there) rather than silently corrupt — the u16 rows of
    this grid pin that."""
    import jax.numpy as jnp

    eb = 8 * elem_sz
    nb = 512
    errs = jnp.asarray(rng.integers(0, 1 << eb, (nb, 8, ndims)), jnp.int32)
    cap = jnp.asarray(rng.integers(0, eb + 1, (nb, 1, ndims)), jnp.int32)
    errs = errs & ((1 << cap) - 1)
    orm = jnp.bitwise_or.reduce(errs, axis=1)
    widths = jnp.asarray(block_widths_rowmajor(orm, elem_sz), jnp.int32)
    errs = errs & ((1 << widths)[:, None, :] - 1)
    dense = pack.pack_rows_rowmajor(errs, widths, elem_sz)
    got = pack.unpack_rows_rowmajor(dense.astype(jnp.int32), widths,
                                    elem_sz=elem_sz)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(errs))


@pytest.mark.parametrize("codec,runs,ndims,elem_sz",
                         [("delta", False, 64, 1), ("xff", False, 64, 1),
                          ("delta", True, 64, 1), ("delta", False, 16, 2),
                          ("delta", True, 16, 2), ("delta", False, 32, 1)])
def test_decode_identical_across_variants(rng, codec, runs, ndims,
                                          elem_sz):
    """Full streams decode identically under bf16/bf3 x nwin auto/3
    (contiguous + runs paths; d32 exercises the rowmajor fold)."""
    from sprintz_jax import decoder, encoder

    dt = np.uint8 if elem_sz == 1 else np.uint16
    lim = 6 if elem_sz == 1 else 600
    n = 6000
    seg = rng.integers(-lim, lim + 1, (n, ndims))
    if runs:
        seg = np.where((np.arange(n) // 64 % 3 == 0)[:, None], 0, seg)
    x = (np.cumsum(seg, axis=0) % (1 << (8 * elem_sz))
         ).astype(dt).reshape(-1)
    s = encoder.compress(x, ndims, codec=codec, elem_sz=elem_sz)
    prev_i, prev_n = pack.MXU_IMPL, pack.UNPACK_NWIN
    try:
        for impl in ("bf16", "bf3"):
            for nw in ("auto", "3"):
                pack.MXU_IMPL, pack.UNPACK_NWIN = impl, nw
                jax.clear_caches()
                out = decoder.decompress(s, codec, elem_sz)
                np.testing.assert_array_equal(out, x)
    finally:
        pack.MXU_IMPL, pack.UNPACK_NWIN = prev_i, prev_n
        jax.clear_caches()


@pytest.mark.parametrize("codec", ["delta", "xff"])
def test_encode_bytes_identical_nwin(rng, codec):
    """u8 streams must be byte-identical with 2 vs 3 pack windows and
    under the bf3 unpack (the encoder's width probe also unpacks)."""
    from sprintz_jax import encoder

    x = (np.cumsum(rng.integers(-6, 7, (5000, 33)), axis=0)
         % 256).astype(np.uint8).reshape(-1)
    prev_i, prev_n = pack.MXU_IMPL, pack.UNPACK_NWIN
    try:
        streams = {}
        for key, impl, nw in (("base", "bf16", "3"), ("nwin", "bf16", "auto"),
                              ("bf3", "bf3", "auto")):
            pack.MXU_IMPL, pack.UNPACK_NWIN = impl, nw
            jax.clear_caches()
            streams[key] = encoder.compress(x, 33, codec=codec)
        assert streams["nwin"] == streams["base"]
        assert streams["bf3"] == streams["base"]
    finally:
        pack.MXU_IMPL, pack.UNPACK_NWIN = prev_i, prev_n
        jax.clear_caches()
