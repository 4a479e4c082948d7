"""Native C++ host runtime == Python reference on random streams."""

import numpy as np
import pytest

from sprintz_jax import native_host
from sprintz_jax.decoder import _walk_headers_py, walk_headers
from sprintz_jax.golden.stream import read_metadata_rle
from sprintz_jax.planner import _build_plan_py

from conftest import make_stream

pytestmark = pytest.mark.skipif(
    native_host.get_lib() is None, reason="native host lib unavailable")


def test_build_plan_native_matches_py(rng):
    for ndims in [1, 7]:
        for trial in range(20):
            nb = int(rng.integers(2, 400))
            n = nb * 8 * ndims + int(rng.integers(0, 8 * ndims))
            # random zero-flag patterns incl. long runs
            zf = (rng.random(n // (8 * ndims) + 1) < rng.random()).astype(
                np.uint8)
            for eq in (False, True):
                py = _build_plan_py(zf, n, ndims, eq)
                nat = native_host.build_plan_native(zf, n, ndims, eq)
                kinds, values, ngroups, consumed, remaining = nat
                np.testing.assert_array_equal(kinds, py.kinds)
                np.testing.assert_array_equal(values, py.values)
                assert (ngroups, consumed, remaining) == (
                    py.ngroups, py.consumed_blocks, py.remaining_elems)


def test_walk_headers_native_matches_py(rng):
    from sprintz_jax import encoder

    for codec in ("delta", "xff"):
        for elem_sz in (1, 2):
            for ndims in (1, 9):
                lowdim = ndims <= (4 if elem_sz == 1 else 2)
                x = make_stream(rng, 900 * ndims, elem_sz, "sparse")
                buf = encoder.compress(x, ndims, codec=codec)
                ngroups, remaining, nd = read_metadata_rle(buf)
                if ngroups == 0:
                    continue
                py = _walk_headers_py(buf, ngroups, ndims, elem_sz,
                                      lowdim=lowdim)
                nat = walk_headers(buf, ngroups, ndims, elem_sz,
                                   lowdim=lowdim)
                np.testing.assert_array_equal(nat.widths, py.widths)
                np.testing.assert_array_equal(
                    nat.payload_offsets, py.payload_offsets)
                np.testing.assert_array_equal(nat.out_rows, py.out_rows)
                assert nat.total_rows == py.total_rows
                assert nat.tail_offset == py.tail_offset


def test_gather_units_native_matches_py(rng, monkeypatch):
    """Native threaded-memcpy gather == numpy fancy-index gather, for
    rowmajor and lowdim streams with runs."""
    from sprintz_jax import decoder, encoder

    if native_host.get_lib() is None:
        pytest.skip("native lib unavailable")
    for ndims, elem_sz in ((24, 1), (3, 1), (9, 2)):
        flat = make_stream(rng, 6000 * ndims, elem_sz, "sparse")
        stream = encoder.compress(flat, ndims, codec="delta")
        ngroups, _, _ = read_metadata_rle(stream)
        lowdim = ndims <= (4 if elem_sz == 1 else 2)
        idx = walk_headers(stream, ngroups, ndims, elem_sz, lowdim=lowdim)
        d_nat = decoder.gather_payloads(stream, idx, ndims, elem_sz, lowdim)
        monkeypatch.setattr(native_host, "gather_units_native",
                            lambda *a, **k: False)
        d_py = decoder.gather_payloads(stream, idx, ndims, elem_sz, lowdim)
        monkeypatch.undo()
        np.testing.assert_array_equal(d_nat, d_py)


def test_gather_units_native_rejects_out_of_range():
    out = np.zeros(16, np.uint8)
    if native_host.get_lib() is None:
        pytest.skip("native lib unavailable")
    ok = native_host.gather_units_native(
        b"abcd", np.array([2]), np.array([0]), np.array([8]), out)
    assert not ok  # src overruns the buffer
    ok = native_host.gather_units_native(
        b"abcdefgh", np.array([0]), np.array([12]), np.array([8]), out)
    assert not ok  # dst overruns the output


def test_walk_gather_fused_matches_serial(rng):
    """index_and_gather's fused native pass must equal walk_headers +
    gather_payloads exactly — contiguous, runs-containing, and u16
    streams, plus the maxb re-bucket retry (a late wide block)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from sprintz_jax import decoder, encoder
    from sprintz_jax.golden.stream import read_metadata_rle

    cases = []
    raw = (np.cumsum(rng.integers(-6, 7, (4096, 24)), axis=0)
           % 256).astype(np.uint8)
    cases.append((raw, 24, 1))
    m = (np.arange(4096) // 64 % 3 == 0)[:, None]
    seg = rng.integers(-6, 7, (4096, 24))
    cases.append(((np.cumsum(np.where(m, 0, seg), axis=0) % 256
                   ).astype(np.uint8), 24, 1))
    raw16 = (np.cumsum(rng.integers(-6, 7, (4096, 12)), axis=0)
             % 65536).astype(np.uint16)
    cases.append((raw16, 12, 2))
    # late wide block: tiny deltas for 1000 blocks, then full-range rows
    # (the 64-group sample underestimates maxb -> native returns -3 and
    # the caller re-buckets)
    wide = (np.cumsum(rng.integers(-2, 3, (16384, 24)), axis=0)
            % 256).astype(np.uint8)
    wide[-256:] = rng.integers(0, 256, (256, 24))
    cases.append((wide, 24, 1))
    for raw, D, esz in cases:
        s = encoder.compress(raw.reshape(-1), D, codec="delta",
                             elem_sz=esz)
        ng, _, _ = read_metadata_rle(s)
        idx0 = decoder.walk_headers(s, ng, D, esz, lowdim=False)
        d0 = decoder.gather_payloads(s, idx0, D, esz, False)
        idx1, d1 = decoder.index_and_gather(s, ng, D, esz, False)
        assert np.array_equal(idx0.widths, idx1.widths)
        assert np.array_equal(idx0.payload_offsets, idx1.payload_offsets)
        assert np.array_equal(idx0.out_rows, idx1.out_rows)
        assert idx0.total_rows == idx1.total_rows
        assert idx0.tail_offset == idx1.tail_offset
        assert d0.shape == d1.shape and np.array_equal(d0, d1)


@pytest.mark.parametrize("lowdim_d,runs", [(None, False), (None, True),
                                           (3, False)])
def test_index_and_gather_pad_dense(rng, lowdim_d, runs):
    """pad_dense=True must return the same payload with exactly
    next_bucket(ndata) zero-tailed leading rows, on both the fused
    native path and the walk+gather fallback (lowdim), including when
    the bucket exceeds the walk buffer (copy fallback)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from sprintz_jax import decoder, encoder
    from sprintz_jax.golden.stream import read_metadata_rle
    from sprintz_jax.utils.shapes import next_bucket

    D = lowdim_d or 24
    lowdim = lowdim_d is not None
    n = 4096
    seg = rng.integers(-6, 7, (n, D))
    if runs:
        seg = np.where((np.arange(n) // 64 % 3 == 0)[:, None], 0, seg)
    raw = (np.cumsum(seg, axis=0) % 256).astype(np.uint8)
    s = encoder.compress(raw.reshape(-1), D, codec="delta")
    ng, _, _ = read_metadata_rle(s)
    i0, d0 = decoder.index_and_gather(s, ng, D, 1, lowdim)
    i1, d1 = decoder.index_and_gather(s, ng, D, 1, lowdim,
                                      pad_dense=True)
    nd = i0.widths.shape[0]
    assert i1.widths.shape[0] == nd
    assert d1.shape[0] == next_bucket(nd)
    assert np.array_equal(d0, d1[:nd])
    assert not d1[nd:].any()
    # the production decode consumes the padded dense
    out = decoder.decompress(s, "delta", 1)
    assert np.array_equal(out, raw.reshape(-1))
