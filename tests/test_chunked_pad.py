"""_chunked must handle non-chunk-aligned leading dims.

Regression for the session-37 crash: the grouped lowdim encode produces
c = ceil(nb/G) grouped rows, which exceeds ops.pack._CHUNK without
being a multiple of it for any large non-power-of-two stream (e.g.
every d3 stream, since G=32 folds of an arbitrary nb land on ragged c).
_chunked now zero-pads the leading axis and slices back. _CHUNK is
shrunk via monkeypatch so the ragged path runs at test sizes; the flag
is trace-time, so caches are cleared around it.
"""

import jax
import numpy as np
import pytest

import sprintz_jax.ops.pack as pack
from sprintz_jax import decoder, encoder


@pytest.fixture
def tiny_chunk(monkeypatch):
    monkeypatch.setattr(pack, "_CHUNK", 16)
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("ndims,elem_sz", [(3, 1), (4, 1), (2, 2), (64, 1)])
def test_roundtrip_ragged_chunks(rng, tiny_chunk, ndims, elem_sz):
    dt = np.uint8 if elem_sz == 1 else np.uint16
    # nb = 520 blocks: grouped c = ceil(520/32) = 17 (> _CHUNK=16 and
    # ragged) for d3/d4; rowmajor nb=520 is 8 mod 16 — ragged too
    nrows = 8 * 520
    raw = (np.cumsum(rng.integers(-5, 6, (nrows, ndims)), axis=0)
           % (1 << (8 * elem_sz))).astype(dt)
    s = encoder.compress(raw.reshape(-1), ndims, codec="delta",
                         elem_sz=elem_sz)
    out = decoder.decompress(s, codec="delta", elem_sz=elem_sz)
    np.testing.assert_array_equal(out, raw.reshape(-1))


def test_chunked_pad_matches_direct(rng, tiny_chunk):
    """pack/unpack through the ragged chunk path == one direct call."""
    import jax.numpy as jnp

    from sprintz_jax.ops.bitmath import block_widths_rowmajor

    nb = 37  # > _CHUNK=16, not a multiple
    errs = jnp.asarray(rng.integers(0, 64, (nb, 8, 16)), jnp.int32)
    orm = jnp.bitwise_or.reduce(errs, axis=1)
    widths = jnp.asarray(block_widths_rowmajor(orm, 1), jnp.int32)
    errs = errs & ((1 << widths)[:, None, :] - 1)
    dense = pack.pack_rows_rowmajor(errs, widths, 1)
    got = pack.unpack_rows_rowmajor(dense.astype(jnp.int32), widths,
                                    elem_sz=1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(errs))
