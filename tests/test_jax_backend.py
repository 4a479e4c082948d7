"""JAX backend: byte-exactness vs golden and lossless round-trips."""

import itertools

import numpy as np
import pytest

from sprintz_jax import decoder, encoder
from sprintz_jax.golden.lowdim import compress_lowdim_rle
from sprintz_jax.golden.rowmajor import compress_rowmajor_rle

from conftest import make_stream


@pytest.mark.parametrize("ndims", [1, 3, 5, 16])
@pytest.mark.parametrize("codec,elem_sz", itertools.product(
    ["delta", "xff"], [1, 2]))
def test_jax_matches_golden(rng, codec, elem_sz, ndims):
    # per-ndims params let xdist spread the slow xff/CPU-scan cases
    for _ in [None]:
        for kind in ["rand", "small", "zeros", "sparse"]:
            x = make_stream(rng, 500 * ndims, elem_sz, kind)
            lowdim = ndims <= (4 if elem_sz == 1 else 2)
            gold = (compress_lowdim_rle if lowdim else compress_rowmajor_rle)(
                x, ndims, codec=codec)
            mine = encoder.compress(x, ndims, codec=codec)
            assert mine == gold, f"{codec}/{elem_sz}/{ndims}/{kind}"
            dec = decoder.decompress(mine, codec=codec, elem_sz=elem_sz)
            np.testing.assert_array_equal(dec, x)


def test_forecaster_exactness(rng):
    # JAX forecasters vs golden predictor state machines, incl. wraparound
    import jax.numpy as jnp

    from sprintz_jax.golden.predictors import FirePredictor
    from sprintz_jax.models.forecasters import fire_decode, fire_encode

    for elem_sz, trunc in [(1, True), (1, False), (2, True), (2, False)]:
        eb = 8 * elem_sz
        dt = np.uint8 if elem_sz == 1 else np.uint16
        rows = make_stream(rng, 8 * 50 * 3, elem_sz, "rand").reshape(-1, 3)
        p = FirePredictor(3, elem_sz, truncate_coeffs=trunc)
        gold = np.concatenate(
            [p.encode_block(rows[i * 8:(i + 1) * 8]) for i in range(50)])
        mine = np.asarray(fire_encode(jnp.asarray(rows, jnp.int32), eb, trunc))
        np.testing.assert_array_equal(mine, gold.astype(np.int32))
        dec = np.asarray(fire_decode(jnp.asarray(mine, jnp.int32), eb, trunc))
        np.testing.assert_array_equal(dec.astype(dt), rows)


def test_compress_batch_byte_exact(rng):
    from sprintz_jax import encoder

    S, rows, D = 5, 700, 9
    streams = make_stream(rng, S * rows * D, 1, "sparse").reshape(S, rows, D)
    batch = encoder.compress_batch(streams, codec="xff")
    for s in range(S):
        assert batch[s] == encoder.compress(
            streams[s].reshape(-1), D, codec="xff")


def test_decompress_batch(rng):
    """Batched decode == per-stream decode, mixed content (contiguous,
    RLE-heavy fallback, verbatim-small)."""
    from sprintz_jax.decoder import decompress_batch

    D = 9
    streams = []
    for kind, n in [("rand", 900), ("small", 1200), ("zeros", 2000),
                    ("rand", 12), ("sparse", 1500)]:
        x = make_stream(rng, n * D if n > 12 else n, 1, kind)
        streams.append(x)
    bufs = [encoder.compress(x, D, codec="xff") for x in streams]
    outs = decompress_batch(bufs, codec="xff", elem_sz=1)
    for x, got, buf in zip(streams, outs, bufs):
        np.testing.assert_array_equal(got, x)
        np.testing.assert_array_equal(
            got, decoder.decompress(buf, codec="xff", elem_sz=1))


@pytest.mark.parametrize("codec,D", [("delta", 4), ("xff", 64),
                                     ("delta", 64)])
def test_decompress_batch_runs_streams(rng, codec, D):
    """Streams containing RLE runs batch through the vmapped
    block-gather timeline (VERDICT r2 item 6) — not per-stream decode."""
    from sprintz_jax.decoder import decompress_batch

    streams = []
    for s in range(4):
        seg = rng.integers(-5, 6, (600 + 160 * s, D))
        m = (np.arange(seg.shape[0]) // 40 % 3 == 0)[:, None]
        streams.append((np.cumsum(np.where(m, 0, seg), axis=0) % 256
                        ).astype(np.uint8).reshape(-1))
    bufs = [encoder.compress(x, D, codec=codec) for x in streams]
    # confirm these streams actually contain runs (else the test is vacuous)
    idx = decoder.walk_headers(
        bufs[0], *__import__("sprintz_jax.golden.stream",
                             fromlist=["read_metadata_rle"]
                             ).read_metadata_rle(bufs[0])[0:1],
        D, 1, lowdim=D <= 4)
    assert idx.total_rows > idx.widths.shape[0] * 8
    outs = decompress_batch(bufs, codec=codec, elem_sz=1)
    for x, got in zip(streams, outs):
        np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("codec", ["delta", "xff"])
def test_ragged_decode_matches(rng, codec, monkeypatch):
    """SPRINTZ_RAGGED_DECODE=1 (ragged-dot unpack over signature-sorted
    blocks) must decode identically on contiguous and runs streams."""
    D = 64
    for kind in ("contig", "runs"):
        seg = rng.integers(-6, 7, (3000, D))
        if kind == "runs":
            seg[(np.arange(3000) // 64 % 3 == 0)] = 0
        x = (np.cumsum(seg, axis=0) % 256).astype(np.uint8).reshape(-1)
        buf = encoder.compress(x, D, codec=codec)
        want = decoder.decompress(buf, codec=codec, elem_sz=1)
        monkeypatch.setenv("SPRINTZ_RAGGED_DECODE", "1")
        got = decoder.decompress(buf, codec=codec, elem_sz=1)
        monkeypatch.delenv("SPRINTZ_RAGGED_DECODE")
        np.testing.assert_array_equal(got, want, err_msg=f"{codec}/{kind}")
        np.testing.assert_array_equal(got, x)


def test_maxb_bucket_mult8_matches(rng, monkeypatch):
    """SPRINTZ_MAXB_BUCKET=mult8 sizes the dense unpack buffer to the
    next multiple of 8 above the stream's max row bytes (vs pow2);
    decode must be unchanged for every codec/layout it touches."""
    monkeypatch.setattr(decoder, "MAXB_BUCKET", "mult8")
    for codec, D, kind in [("delta", 40, "rand"), ("xff", 40, "small"),
                           ("delta", 40, "sparse"), ("delta", 9, "rand")]:
        x = make_stream(rng, 1000 * D, 1, kind)
        buf = encoder.compress(x, D, codec=codec)
        out = decoder.decompress(buf, codec=codec, elem_sz=1)
        np.testing.assert_array_equal(out, x)
    x16 = make_stream(rng, 600 * 24, 2, "rand")
    buf = encoder.compress(x16, 24, codec="delta")
    out = decoder.decompress(buf, codec="delta", elem_sz=2)
    np.testing.assert_array_equal(out, x16)


def test_grouped_decode_optin_matches(rng, monkeypatch):
    """SPRINTZ_GROUPED_DECODE=1 routes runs-containing rowmajor streams
    through the width-signature-grouped pass; output must match the
    default pass bit-for-bit."""
    D = 16
    x = make_stream(rng, 3000 * D, 1, "sparse")  # sparse -> RLE runs
    buf = encoder.compress(x, D, codec="delta")
    base = decoder.decompress(buf, codec="delta", elem_sz=1)
    monkeypatch.setenv("SPRINTZ_GROUPED_DECODE", "1")
    grouped = decoder.decompress(buf, codec="delta", elem_sz=1)
    np.testing.assert_array_equal(grouped, base)
    np.testing.assert_array_equal(base, x)


def test_api_batch_roundtrip(rng):
    """SprintzCodec.compress_batch/decompress_batch == per-stream, both
    codecs, u8+u16 (the batch axis is the device throughput surface for
    fleets of small streams)."""
    from sprintz_jax.api import SprintzCodec

    for codec, esz, d in (("delta", 1, 4), ("xff", 2, 9)):
        dt = np.uint8 if esz == 1 else np.uint16
        c = SprintzCodec(codec, esz)
        arrs = [(np.cumsum(rng.integers(-5, 6, (1200, d)), axis=0)
                 % (1 << (8 * esz))).astype(dt) for _ in range(4)]
        bufs = c.compress_batch(arrs)
        assert bufs == [c.compress(a) for a in arrs]
        for a, o in zip(arrs, c.decompress_batch(bufs)):
            np.testing.assert_array_equal(o, a.reshape(-1))

def test_api_batch_dtype_mismatch_raises(rng):
    """ADVICE r3 (medium): a SprintzCodec(elem_sz=1) given uint16 arrays
    must raise like the single-stream path, not silently write u16
    streams through the batched fast path."""
    from sprintz_jax.api import SprintzCodec

    c = SprintzCodec("delta", 1)
    arrs = [rng.integers(0, 1 << 16, (160, 4)).astype(np.uint16)
            for _ in range(2)]
    with pytest.raises(TypeError):
        c.compress_batch(arrs)
    # and the right dtype still takes the fast path / round-trips
    ok = [a.astype(np.uint8) for a in arrs]
    assert c.compress_batch(ok) == [c.compress(a) for a in ok]
