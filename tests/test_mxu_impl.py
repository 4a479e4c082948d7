"""MXU number-format variants (ops/pack.MXU_IMPL): bf16 vs s8.

The exact-matmul kernels admit two formats: bf16 inputs with power-of-two
weights (proved exact by magnitude bounds) and s8*s8->s32
(exact by integer arithmetic). Both must produce identical results; the
flag is read at trace time, so each parametrization clears jit caches.
"""

import jax
import numpy as np
import pytest

import sprintz_jax.ops.pack as pack
from sprintz_jax.models import forecasters as fc
from sprintz_jax.ops.bitmath import block_widths_rowmajor


@pytest.fixture(params=["bf16", "s8"])
def mxu_impl(request):
    prev = pack.MXU_IMPL
    pack.MXU_IMPL = request.param
    jax.clear_caches()
    yield request.param
    pack.MXU_IMPL = prev
    jax.clear_caches()


@pytest.mark.parametrize("ndims,elem_sz", [(64, 1), (40, 2), (5, 1)])
def test_unpack_pack_roundtrip(rng, mxu_impl, ndims, elem_sz):
    import jax.numpy as jnp

    eb = 8 * elem_sz
    nb = 512
    errs = jnp.asarray(rng.integers(0, 1 << (eb - 2), (nb, 8, ndims)),
                       jnp.int32)
    orm = jnp.bitwise_or.reduce(errs, axis=1)
    widths = jnp.asarray(block_widths_rowmajor(orm, elem_sz), jnp.int32)
    errs = errs & ((1 << widths)[:, None, :] - 1)
    dense = pack.pack_rows_rowmajor(errs, widths, elem_sz)
    got = pack.unpack_rows_rowmajor(dense.astype(jnp.int32), widths,
                                    elem_sz=elem_sz)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(errs))


@pytest.fixture(params=["bf16", "s8"])
def prefix_impl(request):
    prev = fc.PREFIX_IMPL
    fc.PREFIX_IMPL = request.param
    jax.clear_caches()
    yield request.param
    fc.PREFIX_IMPL = prev
    jax.clear_caches()


@pytest.mark.parametrize("value_bits", [8, 16])
@pytest.mark.parametrize("chunk", [128, 256, 512])
def test_hierarchical_cumsum_exact(rng, prefix_impl, value_bits, chunk):
    import jax.numpy as jnp

    lim = 1 << (value_bits - 1)
    x = jnp.asarray(rng.integers(-lim, lim, (4000, 33)), jnp.int32)
    got = np.asarray(
        fc.hierarchical_cumsum(x, chunk=chunk, value_bits=value_bits))
    want = np.cumsum(np.asarray(x, np.int64), axis=0).astype(np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("codec", ["delta", "xff"])
@pytest.mark.parametrize("elem_sz", [1, 2])
def test_stream_bytes_identical_across_impls(rng, codec, elem_sz):
    """The MXU format is an implementation detail: compressed bytes must
    be bit-identical under bf16 and s8."""
    from sprintz_jax import encoder

    flat = np.cumsum(rng.integers(-9, 10, 2000 * 33)).astype(
        np.uint8 if elem_sz == 1 else np.uint16)
    streams = {}
    prev = pack.MXU_IMPL
    try:
        for impl in ("bf16", "s8"):
            pack.MXU_IMPL = impl
            jax.clear_caches()
            streams[impl] = encoder.compress(flat, 33, codec=codec)
    finally:
        pack.MXU_IMPL = prev
        jax.clear_caches()
    assert streams["bf16"] == streams["s8"]


def test_s8_full_stream_roundtrip(rng):
    """End-to-end compress/decompress under the s8 MXU format."""
    from sprintz_jax import decoder, encoder

    prev = pack.MXU_IMPL
    pack.MXU_IMPL = "s8"
    jax.clear_caches()
    try:
        for codec in ("delta", "xff"):
            flat = np.where(rng.random(3000 * 24) < 0.1,
                            rng.integers(0, 60000, 3000 * 24), 0
                            ).astype(np.uint16)
            stream = encoder.compress(flat, 24, codec=codec)
            out = decoder.decompress(stream, codec, 2)
            np.testing.assert_array_equal(out, flat)
    finally:
        pack.MXU_IMPL = prev
        jax.clear_caches()


@pytest.fixture(params=["select", "einsum", "wselect", "einsum2", "dyn",
                        "wbank", "jsel", "auto"])
def lowdim_impl(request):
    prev = pack.LOWDIM_IMPL
    pack.LOWDIM_IMPL = request.param
    jax.clear_caches()
    yield request.param
    pack.LOWDIM_IMPL = prev
    jax.clear_caches()


@pytest.mark.parametrize("ndims,elem_sz", [(1, 1), (4, 1), (2, 2)])
def test_lowdim_impl_roundtrip(rng, lowdim_impl, ndims, elem_sz):
    """Both lowdim formulations (VPU select-accumulate with blocks in
    lanes vs per-(block,dim) matmuls) must produce identical payload
    bytes and invert exactly."""
    import jax.numpy as jnp

    from sprintz_jax.ops.bitmath import block_widths_lowdim

    eb = 8 * elem_sz
    nb = 512
    # full-range values with per-block random width caps so every legal
    # width (including the eb-1 -> eb promotion) is exercised
    errs = jnp.asarray(rng.integers(0, 1 << eb, (nb, 8, ndims)), jnp.int32)
    cap = jnp.asarray(rng.integers(0, eb + 1, (nb, 1, ndims)), jnp.int32)
    errs = errs & ((1 << cap) - 1)
    orm = jnp.bitwise_or.reduce(errs, axis=1)
    widths = jnp.asarray(block_widths_lowdim(orm, elem_sz), jnp.int32)
    errs = errs & ((1 << widths)[:, None, :] - 1)
    dense = pack.pack_dims_lowdim(errs, widths, elem_sz)
    got = pack.unpack_dims_lowdim(dense.astype(jnp.int32), widths)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(errs))


@pytest.mark.parametrize("prefix_chunk", [256, 512])
@pytest.mark.parametrize("value_bits,ncols", [(8, 1), (8, 4), (16, 2)])
def test_hierarchical_cumsum_last_exact(rng, prefix_impl, value_bits,
                                        ncols, prefix_chunk):
    """The last-axis (dim-major) prefix must match the int64 oracle for
    both MXU formats, including a non-multiple-of-chunk length."""
    import jax.numpy as jnp

    lim = 1 << (value_bits - 1)
    n = 4000  # not a multiple of chunk
    x = rng.integers(-lim, lim, (ncols, n))
    got = np.asarray(fc.hierarchical_cumsum_last(
        jnp.asarray(x, jnp.int32), chunk=prefix_chunk,
        value_bits=value_bits))
    ref = np.cumsum(x.astype(np.int64), axis=-1).astype(np.int32)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ndims,elem_sz", [(1, 1), (2, 1), (4, 1), (1, 2),
                                           (2, 2)])
def test_dmajor_unpack_matches_legacy(rng, ndims, elem_sz):
    """The dim-major unpack must agree with the batched lowdim unpack
    across every legal width (incl. promotions)."""
    import jax.numpy as jnp

    from sprintz_jax.ops.bitmath import block_widths_lowdim

    eb = 8 * elem_sz
    nb = 512
    errs = jnp.asarray(rng.integers(0, 1 << eb, (nb, 8, ndims)), jnp.int32)
    cap = jnp.asarray(rng.integers(0, eb + 1, (nb, 1, ndims)), jnp.int32)
    errs = errs & ((1 << cap) - 1)
    orm = jnp.bitwise_or.reduce(errs, axis=1)
    widths = jnp.asarray(block_widths_lowdim(orm, elem_sz), jnp.int32)
    errs = errs & ((1 << widths)[:, None, :] - 1)
    dense = pack.pack_dims_lowdim(errs, widths, elem_sz)
    slots = pack.unpack_dims_lowdim_dmajor(dense, widths)  # 8 x (D, nb)
    got = np.stack([np.asarray(s) for s in slots], axis=-1)  # (D, nb, 8)
    want = np.asarray(errs).transpose(2, 0, 1)
    np.testing.assert_array_equal(got, want)
    # the encode-side twin must reproduce the packed bytes exactly
    repacked = pack.pack_fields_lowdim_dmajor(
        [jnp.asarray(got[:, :, r]) for r in range(8)],
        jnp.asarray(np.asarray(widths).T), elem_sz)
    np.testing.assert_array_equal(np.asarray(repacked), np.asarray(dense))


@pytest.mark.parametrize("ndims,elem_sz", [(1, 1), (2, 1), (4, 1), (1, 2),
                                           (2, 2)])
def test_dynshift_unpack_matches_legacy(rng, ndims, elem_sz):
    """The dynamic-shift unpack/pack twins must agree with the batched
    lowdim formats across every legal width (incl. promotions)."""
    import jax.numpy as jnp

    from sprintz_jax.ops.bitmath import block_widths_lowdim

    eb = 8 * elem_sz
    nb = 512
    errs = jnp.asarray(rng.integers(0, 1 << eb, (nb, 8, ndims)), jnp.int32)
    cap = jnp.asarray(rng.integers(0, eb + 1, (nb, 1, ndims)), jnp.int32)
    errs = errs & ((1 << cap) - 1)
    orm = jnp.bitwise_or.reduce(errs, axis=1)
    widths = jnp.asarray(block_widths_lowdim(orm, elem_sz), jnp.int32)
    errs = errs & ((1 << widths)[:, None, :] - 1)
    dense = pack.pack_dims_lowdim(errs, widths, elem_sz)
    slots = pack.unpack_dims_lowdim_dynshift(dense, widths)  # 8 x (D, nb)
    got = np.stack([np.asarray(s) for s in slots], axis=-1)  # (D, nb, 8)
    want = np.asarray(errs).transpose(2, 0, 1)
    np.testing.assert_array_equal(got, want)
    repacked = pack.pack_fields_lowdim_dynshift(
        [jnp.asarray(got[:, :, r]) for r in range(8)],
        jnp.asarray(np.asarray(widths).T), elem_sz)
    np.testing.assert_array_equal(np.asarray(repacked), np.asarray(dense))


@pytest.mark.parametrize("ndims,elem_sz", [(2, 1), (4, 1), (2, 2)])
def test_pack_rows_from_dmajor_bitcast(rng, ndims, elem_sz):
    """The u32-word row packing must invert the row->planes split."""
    import jax.numpy as jnp

    eb = 8 * elem_sz
    vals = rng.integers(0, 1 << eb, (ndims, 1024))
    got = np.asarray(pack.pack_rows_from_dmajor(
        jnp.asarray(vals, jnp.int32), elem_sz))
    np.testing.assert_array_equal(got, vals.T.astype(got.dtype))


@pytest.mark.parametrize("ndims,elem_sz", [(1, 1), (2, 1), (4, 1), (1, 2),
                                           (2, 2)])
def test_interleave_rows_dmajor(rng, ndims, elem_sz):
    """The one-transpose slot interleave must produce time-ordered rows."""
    import jax.numpy as jnp

    eb = 8 * elem_sz
    nb = 256
    want = rng.integers(0, 1 << eb, (nb * 8, ndims))
    slots = [jnp.asarray(want.reshape(nb, 8, ndims)[:, r].T, jnp.int32)
             for r in range(8)]
    got = np.asarray(pack.interleave_rows_dmajor(slots, elem_sz))
    np.testing.assert_array_equal(got, want.astype(got.dtype))


@pytest.mark.parametrize("ndims,elem_sz", [(1, 1), (2, 1), (4, 1), (2, 2)])
def test_dmajor_encode_bytes_identical(rng, ndims, elem_sz):
    """The dim-major encode pass must emit byte-identical streams."""
    from sprintz_jax import encoder

    dt = np.uint8 if elem_sz == 1 else np.uint16
    x = np.where(rng.random(4000 * ndims) < 0.3,
                 rng.integers(0, 1 << (8 * elem_sz), 4000 * ndims),
                 0).astype(dt)
    prev = encoder.LOWDIM_DMAJOR
    try:
        streams = {}
        for flag in (True, False):
            encoder.LOWDIM_DMAJOR = flag
            jax.clear_caches()
            streams[flag] = encoder.compress(x, ndims, codec="delta",
                                             elem_sz=elem_sz)
        assert streams[True] == streams[False]
    finally:
        encoder.LOWDIM_DMAJOR = prev
        jax.clear_caches()


@pytest.mark.parametrize("ndims,elem_sz", [(1, 1), (3, 1), (4, 1), (2, 2)])
def test_grouped_unpack_pack_match(rng, ndims, elem_sz):
    """Group-folded unpack/pack must be bit-identical to the plain
    batched forms, including at nb not a multiple of the group."""
    import jax.numpy as jnp

    from sprintz_jax.ops.bitmath import block_widths_lowdim

    eb = 8 * elem_sz
    nb = 517  # deliberately not a multiple of any group size
    errs = jnp.asarray(rng.integers(0, 1 << eb, (nb, 8, ndims)), jnp.int32)
    cap = jnp.asarray(rng.integers(0, eb + 1, (nb, 1, ndims)), jnp.int32)
    errs = errs & ((1 << cap) - 1)
    orm = jnp.bitwise_or.reduce(errs, axis=1)
    widths = jnp.asarray(block_widths_lowdim(orm, elem_sz), jnp.int32)
    errs = errs & ((1 << widths)[:, None, :] - 1)
    dense = pack.pack_dims_lowdim(errs, widths, elem_sz)
    got = pack.unpack_dims_lowdim_grouped(dense, widths)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(errs))
    packed = pack.pack_dims_lowdim_grouped(errs, widths, elem_sz)
    np.testing.assert_array_equal(np.asarray(packed), np.asarray(dense))


@pytest.mark.parametrize("ndims,elem_sz", [(1, 1), (3, 1), (4, 1), (2, 2)])
def test_grouped_decode_pass_identical(rng, ndims, elem_sz):
    """The grouped lowdim pass must decode identically to legacy."""
    from sprintz_jax import decoder, encoder

    dt = np.uint8 if elem_sz == 1 else np.uint16
    lim = 9 if elem_sz == 1 else 900
    x = (np.cumsum(rng.integers(-lim, lim + 1, 4001 * ndims))
         % (1 << (8 * elem_sz))).astype(dt)
    s = encoder.compress(x, ndims, codec="delta", elem_sz=elem_sz)
    prev = decoder.LOWDIM_PASS
    try:
        outs = {}
        for name in ("legacy", "grouped"):
            decoder.LOWDIM_PASS = name
            jax.clear_caches()
            outs[name] = decoder.decompress(s, "delta", elem_sz)
        np.testing.assert_array_equal(outs["grouped"], outs["legacy"])
        np.testing.assert_array_equal(outs["grouped"], x)
    finally:
        decoder.LOWDIM_PASS = prev
        jax.clear_caches()


@pytest.mark.parametrize("ndims,elem_sz", [(1, 1), (2, 1), (3, 1), (4, 1),
                                           (1, 2), (2, 2)])
def test_grouped_scatter_runs_identical(rng, ndims, elem_sz):
    """The grouped flat-scatter runs path must decode RLE-heavy lowdim
    streams identically to the legacy row scatter."""
    from sprintz_jax import decoder, encoder

    dt = np.uint8 if elem_sz == 1 else np.uint16
    lim = 6 if elem_sz == 1 else 600
    n = 6000
    seg = rng.integers(-lim, lim + 1, (n, ndims))
    run_mask = (np.arange(n) // 64 % 3 == 0)[:, None]  # 1/3 rows in runs
    x = (np.cumsum(np.where(run_mask, 0, seg), axis=0)
         % (1 << (8 * elem_sz))).astype(dt).reshape(-1)
    s = encoder.compress(x, ndims, codec="delta", elem_sz=elem_sz)
    prev = decoder.LOWDIM_PASS
    try:
        outs = {}
        for name in ("legacy", "grouped"):
            decoder.LOWDIM_PASS = name
            jax.clear_caches()
            outs[name] = decoder.decompress(s, "delta", elem_sz)
        np.testing.assert_array_equal(outs["grouped"], outs["legacy"])
        np.testing.assert_array_equal(outs["grouped"], x)
    finally:
        decoder.LOWDIM_PASS = prev
        jax.clear_caches()


@pytest.mark.parametrize("ndims,elem_sz,lowdim,codec",
                         [(64, 1, False, "delta"), (64, 1, False, "xff"),
                          (16, 2, False, "delta"), (3, 1, True, "delta"),
                          (3, 1, True, "xff")])
def test_runs_timeline_gather_identical(rng, ndims, elem_sz, lowdim, codec):
    """The block-gather runs timeline must decode RLE-heavy streams
    identically to the legacy row scatter (rowmajor + non-grouped lowdim)."""
    from sprintz_jax import decoder, encoder

    dt = np.uint8 if elem_sz == 1 else np.uint16
    lim = 6 if elem_sz == 1 else 600
    n = 6000
    seg = rng.integers(-lim, lim + 1, (n, ndims))
    run_mask = (np.arange(n) // 64 % 3 == 0)[:, None]  # 1/3 rows in runs
    x = (np.cumsum(np.where(run_mask, 0, seg), axis=0)
         % (1 << (8 * elem_sz))).astype(dt).reshape(-1)
    s = encoder.compress(x, ndims, codec=codec, elem_sz=elem_sz)
    prev = decoder.RUNS_TIMELINE
    try:
        outs = {}
        names = (("scatter", "gather") if lowdim
                 else ("scatter", "gather", "dgather", "ngather"))
        for name in names:
            decoder.RUNS_TIMELINE = name
            jax.clear_caches()
            outs[name] = decoder.decompress(s, codec, elem_sz)
        np.testing.assert_array_equal(outs["gather"], outs["scatter"])
        np.testing.assert_array_equal(outs["gather"], x)
        if "dgather" in outs:
            np.testing.assert_array_equal(outs["dgather"], x)
        if "ngather" in outs:
            np.testing.assert_array_equal(outs["ngather"], x)
    finally:
        decoder.RUNS_TIMELINE = prev
        jax.clear_caches()


@pytest.mark.parametrize("ndims,elem_sz", [(1, 1), (2, 1), (3, 1), (4, 1),
                                           (1, 2), (2, 2)])
def test_grouped_encode_identical(rng, ndims, elem_sz):
    """The grouped lowdim encode pass must emit byte-identical streams
    to the legacy and dmajor formulations (runs + data mix)."""
    from sprintz_jax import encoder

    dt = np.uint8 if elem_sz == 1 else np.uint16
    lim = 6 if elem_sz == 1 else 600
    n = 6000
    seg = rng.integers(-lim, lim + 1, (n, ndims))
    run_mask = (np.arange(n) // 64 % 3 == 0)[:, None]
    x = (np.cumsum(np.where(run_mask, 0, seg), axis=0)
         % (1 << (8 * elem_sz))).astype(dt).reshape(-1)
    prev = encoder.LOWDIM_ENCODE
    try:
        outs = {}
        for name in ("legacy", "dmajor", "grouped"):
            encoder.LOWDIM_ENCODE = name
            jax.clear_caches()
            outs[name] = encoder.compress(x, ndims, codec="delta",
                                          elem_sz=elem_sz)
        assert outs["grouped"] == outs["legacy"]
        assert outs["dmajor"] == outs["legacy"]
    finally:
        encoder.LOWDIM_ENCODE = prev
        jax.clear_caches()


def test_dmajor_decode_toggle_identical(rng):
    """Production lowdim decode must be identical with dmajor on/off."""
    from sprintz_jax import decoder, encoder

    x = (np.cumsum(rng.integers(-9, 10, 4000 * 4)) % 256).astype(np.uint8)
    s = encoder.compress(x, 4, codec="delta")
    prev = decoder.LOWDIM_DMAJOR
    try:
        outs = {}
        for flag in (True, False):
            decoder.LOWDIM_DMAJOR = flag
            jax.clear_caches()
            outs[flag] = decoder.decompress(s, "delta", 1)
        np.testing.assert_array_equal(outs[True], outs[False])
        np.testing.assert_array_equal(outs[True], x)
    finally:
        decoder.LOWDIM_DMAJOR = prev
        jax.clear_caches()


@pytest.mark.parametrize("ndims,elem_sz", [(4, 1), (2, 2)])
def test_lowdim_stream_bytes_identical_across_impls(rng, ndims, elem_sz):
    """The lowdim kernel formulation is an implementation detail: the
    compressed stream must be bit-identical under all three, and each
    must decode the others' output."""
    from sprintz_jax import decoder, encoder

    flat = np.cumsum(rng.integers(-9, 10, 1500 * ndims)).astype(
        np.uint8 if elem_sz == 1 else np.uint16)
    streams = {}
    prev = pack.LOWDIM_IMPL
    try:
        for impl in ("select", "einsum", "wselect"):
            pack.LOWDIM_IMPL = impl
            jax.clear_caches()
            streams[impl] = encoder.compress(flat, ndims, elem_sz=elem_sz)
        assert streams["select"] == streams["einsum"] == streams["wselect"]
        out = decoder.decompress(streams["einsum"], "delta", elem_sz)
        np.testing.assert_array_equal(out, flat)
    finally:
        pack.LOWDIM_IMPL = prev
        jax.clear_caches()


@pytest.mark.parametrize("fold", ["0", "1"])
@pytest.mark.parametrize("value_bits,ncols", [(8, 1), (8, 4), (16, 2),
                                              (16, 64)])
def test_prefix_fold_exact(rng, prefix_impl, fold, value_bits, ncols):
    """Folding chunks into the triangular matmul's minor dim (lowdim
    lane-utilization fix) is a pure layout change: results must equal
    the batched form and the int64 oracle for both MXU formats."""
    import jax.numpy as jnp

    prev = fc.PREFIX_FOLD
    fc.PREFIX_FOLD = fold
    jax.clear_caches()
    try:
        lim = 1 << (value_bits - 1)
        x = rng.integers(-lim, lim, (4000, ncols))
        got = np.asarray(fc.hierarchical_cumsum(
            jnp.asarray(x, jnp.int32), value_bits=value_bits))
        ref = np.cumsum(x.astype(np.int64), axis=0).astype(np.int32)
        np.testing.assert_array_equal(got, ref)
    finally:
        fc.PREFIX_FOLD = prev
        jax.clear_caches()


@pytest.mark.parametrize("codec,runs", [("delta", False), ("xff", False),
                                        ("delta", True)])
def test_unpack_pair_identical(rng, codec, runs):
    """Paired-dim unpack (halved weight tensor) must decode u8 rowmajor
    streams identically to the per-dim formulation (contiguous + runs)."""
    from sprintz_jax import decoder, encoder
    from sprintz_jax.ops import pack

    n, D = 6000, 17
    seg = rng.integers(-6, 7, (n, D))
    if runs:
        seg = np.where((np.arange(n) // 64 % 3 == 0)[:, None], 0, seg)
    x = (np.cumsum(seg, axis=0) % 256).astype(np.uint8).reshape(-1)
    s = encoder.compress(x, D, codec=codec)
    prev = pack.UNPACK_PAIR
    try:
        outs = {}
        for flag in (False, True):
            pack.UNPACK_PAIR = flag
            jax.clear_caches()
            outs[flag] = decoder.decompress(s, codec, 1)
        np.testing.assert_array_equal(outs[True], outs[False])
        np.testing.assert_array_equal(outs[True], x)
    finally:
        pack.UNPACK_PAIR = prev
        jax.clear_caches()


def test_pack_pair_identical(rng):
    """Paired-dim packing must emit byte-identical u8 streams."""
    from sprintz_jax import encoder
    from sprintz_jax.ops import pack

    x = (np.cumsum(rng.integers(-6, 7, (5000, 17)), axis=0)
         % 256).astype(np.uint8).reshape(-1)
    prev = pack.UNPACK_PAIR
    try:
        outs = {}
        for flag in (False, True):
            pack.UNPACK_PAIR = flag
            jax.clear_caches()
            outs[flag] = encoder.compress(x, 17, codec="delta")
        assert outs[True] == outs[False]
    finally:
        pack.UNPACK_PAIR = prev
        jax.clear_caches()


@pytest.mark.parametrize("ndims,elem_sz", [(8, 1), (16, 2), (32, 1),
                                           (64, 1), (64, 2)])
def test_rowmajor_fold_identical(rng, ndims, elem_sz):
    """The block-folded rowmajor delta decode (G = 128/D virtual lanes)
    must match the unfolded pass bit-for-bit."""
    from sprintz_jax import decoder, encoder

    dt = np.uint8 if elem_sz == 1 else np.uint16
    x = (np.cumsum(rng.integers(-6, 7, (3000, ndims)), axis=0)
         % (1 << (8 * elem_sz))).astype(dt).reshape(-1)
    s = encoder.compress(x, ndims, codec="delta", elem_sz=elem_sz)
    prev = decoder.ROWMAJOR_FOLD
    try:
        outs = {}
        for flag in (False, True):
            decoder.ROWMAJOR_FOLD = flag
            jax.clear_caches()
            outs[flag] = decoder.decompress(s, "delta", elem_sz)
        np.testing.assert_array_equal(outs[True], outs[False])
        np.testing.assert_array_equal(outs[True], x)
    finally:
        decoder.ROWMAJOR_FOLD = prev
        jax.clear_caches()
