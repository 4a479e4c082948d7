"""Entropy stage: canonical Huffman tables, round trips, +Huf API."""

import numpy as np
import pytest

import sprintz_jax
from sprintz_jax.entropy import build_table, huff_compress, huff_decompress

from conftest import make_stream


@pytest.mark.parametrize("kind", ["rand", "small", "zeros", "sparse"])
def test_huffman_roundtrip(rng, kind):
    data = make_stream(rng, 60000, 1, kind)
    comp = huff_compress(data)
    for backend in ("auto", "numpy", "jax"):
        np.testing.assert_array_equal(
            huff_decompress(comp, backend=backend), data, err_msg=backend)


def test_huffman_native_matches_numpy(rng):
    """The C++ emitter must produce byte-identical streams to the numpy
    emitter, and both decoders must agree."""
    import sprintz_jax.entropy.huffman as hf
    from sprintz_jax import native_host

    if native_host.get_lib() is None:
        pytest.skip("native host lib unavailable")
    for kind in ("rand", "small", "sparse"):
        data = make_stream(rng, 50_001, 1, kind)
        t = hf.build_table(data)
        native = native_host.huff_encode_native(
            data, hf.DEFAULT_CHUNK_SYMBOLS, t.codes, t.lengths)
        assert native is not None
        comp_native = huff_compress(data)
        # numpy emitter (force by bypassing native)
        import unittest.mock as mock

        with mock.patch.object(
                native_host, "huff_encode_native", lambda *a: None):
            comp_np = huff_compress(data)
        assert comp_native == comp_np, kind


@pytest.mark.parametrize("cs", [62, 64, 128, 512, 4096])
def test_huffman_chunk_sizes_all_backends(rng, cs):
    """The device kernel must be exact at every chunk granularity (the
    decode-speed knob) and across skews, including the junk-peek padding
    region of the final partial chunk."""
    for kind in ("rand", "small", "sparse"):
        data = make_stream(rng, 10_007, 1, kind)
        comp = huff_compress(data, chunk_symbols=cs, allow_stored=False)
        for backend in ("native", "numpy", "jax"):
            np.testing.assert_array_equal(
                huff_decompress(comp, backend=backend), data,
                err_msg=f"{backend} cs={cs} {kind}")


def test_huffman_reads_v1_streams(rng):
    """Round-2 streams (u32 chunk_symbols, u32 sizes) still decode."""
    import sprintz_jax.entropy.huffman as hf

    data = make_stream(rng, 9000, 1, "small")
    v2 = huff_compress(data, chunk_symbols=512)
    n, cs, nchunks, t, sizes, offsets = hf._parse(v2)
    payload = v2[int(offsets[0]):] if nchunks else b""
    v1 = (np.array([n, cs, nchunks], dtype=np.uint32).tobytes()
          + hf._pack_table(t) + sizes.astype(np.uint32).tobytes() + payload)
    for backend in ("native", "numpy", "jax"):
        np.testing.assert_array_equal(
            huff_decompress(v1, backend=backend), data, err_msg=backend)


@pytest.mark.parametrize("cs", [64, 128, 4096])
def test_device_encode_byte_identical(rng, cs):
    """encode_device + host assembly must reproduce the native/numpy
    emitter's bytes exactly (same chunked LSB-first format)."""
    from sprintz_jax.entropy import huff_compress_device

    for kind in ("rand", "small", "sparse", "zeros"):
        for n in (100, 10_007, 50_000):
            data = make_stream(rng, n, 1, kind)
            # compare emitters below the stored-escape wrapper (rand
            # data triggers the escape in the public API)
            import sprintz_jax.entropy.huffman as hf
            ref = hf._huff_compress_host(data, cs, None)
            dev = huff_compress_device(data, chunk_symbols=cs)
            assert dev == ref, f"{kind} n={n} cs={cs}"


def test_canonical_tables_agree_with_lut(rng):
    """canonical_tables (device decode) and decode_lut (host decode) must
    define the same code: every 12-bit peek maps to one (symbol, length)."""
    import sprintz_jax.entropy.huffman as hf

    for kind in ("rand", "small", "sparse"):
        t = hf.build_table(make_stream(rng, 20000, 1, kind))
        sym_lut, len_lut = t.decode_lut()
        limits, adj, perm = t.canonical_tables()
        peek = np.arange(1 << hf.MAX_CODE_LEN)
        v = np.zeros_like(peek)
        for b in range(hf.MAX_CODE_LEN):  # bit-reverse each peek
            v |= ((peek >> b) & 1) << (hf.MAX_CODE_LEN - 1 - b)
        L = 1 + (v[:, None] >= limits[None, :]).sum(axis=1)
        idx = np.clip((v >> (hf.MAX_CODE_LEN - L)) + adj[L], 0, 255)
        ok = len_lut > 0  # LUT entries actually covered by a code
        np.testing.assert_array_equal(L[ok], len_lut[ok].astype(np.int64))
        np.testing.assert_array_equal(perm[idx[ok]],
                                      sym_lut[ok].astype(np.int32))


def test_huffman_edge_cases():
    for data in [np.zeros(0, np.uint8), np.array([3], np.uint8),
                 np.arange(256, dtype=np.uint8)]:
        comp = huff_compress(data)
        np.testing.assert_array_equal(huff_decompress(comp), data)


def test_table_kraft(rng):
    # adversarial skew must still satisfy Kraft with max length 12
    counts_data = np.repeat(np.arange(200, dtype=np.uint8),
                            (np.arange(200) ** 3 // 1000 + 1))
    t = build_table(counts_data)
    used = t.lengths[t.lengths > 0].astype(int)
    assert used.max() <= 12
    assert np.sum(2.0 ** -used) <= 1.0 + 1e-12


def test_plus_huf_api(rng):
    x = (np.cumsum(rng.integers(-5, 6, (3000, 5)), axis=0) % 256
         ).astype(np.uint8)
    plain = sprintz_jax.SprintzCodec("delta", 1)
    huf = sprintz_jax.SprintzCodec("delta", 1, entropy="huffman")
    b0, b1 = plain.compress(x), huf.compress(x)
    np.testing.assert_array_equal(huf.decompress(b1), x.reshape(-1))
    assert len(b1) < len(b0)  # entropy stage helps on smooth data


def test_byte_lookup_matches_indexing(rng):
    """_byte_lookup (flat 63-select byte LUT) == table[idx] for random
    tables and indices."""
    import jax.numpy as jnp

    import sprintz_jax.entropy.huffman as hf

    table = rng.integers(0, 256, 256).astype(np.uint8)
    idx = rng.integers(0, 256, (7, 333)).astype(np.int32)
    lut = hf.pack_byte_lut(table)
    out = np.asarray(hf._byte_lookup(jnp.asarray(idx), jnp.asarray(lut)))
    np.testing.assert_array_equal(out, table[idx].astype(np.int32))


def test_chunk_symbols_u16_limit(rng):
    # ADVICE r3: the v2 header stores chunk_symbols as u16 — oversize
    # values must raise (not assert) before any encode work
    data = rng.integers(0, 256, 1000).astype(np.uint8)
    with pytest.raises(ValueError, match="u16"):
        huff_compress(data, chunk_symbols=1 << 16)


def test_auto_decode_survives_device_failure(rng, monkeypatch):
    # a failing device decode propagates from backend="jax" (no host
    # decode hides it); "auto" is the native host loop and never
    # reaches the device path
    import sprintz_jax.entropy.huffman as hf

    data = rng.integers(0, 200, 5000).astype(np.uint8)
    comp = huff_compress(data)

    def boom(*a, **k):
        raise RuntimeError("simulated device failure")

    monkeypatch.setattr(hf, "_decode_jax", boom)
    with pytest.raises(RuntimeError, match="simulated"):
        huff_decompress(comp, backend="jax")
    np.testing.assert_array_equal(huff_decompress(comp, backend="auto"),
                                  data)


def test_stored_escape_never_loses(rng):
    """VERDICT r4 item 2: +Huf must never lose more than the 12-byte
    stored header to plain sprintz — incompressible input triggers the
    stored escape on every backend."""
    import sprintz_jax.entropy.huffman as hf

    data = rng.integers(0, 256, 50_000).astype(np.uint8)  # ~8 bits/sym
    for backend in ("native", "device"):
        comp = huff_compress(data, chunk_symbols=128, backend=backend)
        assert len(comp) == data.size + hf._STORED_HEAD_LEN
        np.testing.assert_array_equal(huff_decompress(comp), data)
        for dec_backend in ("native", "numpy"):
            np.testing.assert_array_equal(
                huff_decompress(comp, backend=dec_backend), data)
    # compressible input must still encode
    smooth = (np.arange(50_000) % 7).astype(np.uint8)
    comp = huff_compress(smooth, chunk_symbols=128)
    assert len(comp) < smooth.size // 2
    np.testing.assert_array_equal(huff_decompress(comp), smooth)


def test_auto_chunk_size(rng):
    import sprintz_jax.entropy.huffman as hf

    assert hf.DEFAULT_CHUNK_SYMBOLS == 4096
    data = (rng.integers(0, 9, 30_000) ** 2 % 256).astype(np.uint8)
    for n in (data.size, 1 << 22):  # small and large streams alike
        sym = np.resize(data, n)
        comp_auto = huff_compress(sym)
        assert np.frombuffer(comp_auto[4:6], np.uint16)[0] == 4096
        comp_128 = huff_compress(sym, chunk_symbols=128)
        assert len(comp_auto) < len(comp_128)
        np.testing.assert_array_equal(huff_decompress(comp_auto), sym)


def test_codec_entropy_zero_overhead_escape(rng):
    """The +Huf codec never emits a single byte more than plain sprintz:
    when Huffman doesn't pay, the plain stream ships verbatim and
    decompress routes on the strict container check."""
    import sprintz_jax
    import sprintz_jax.entropy.huffman as hf

    plain = sprintz_jax.SprintzCodec("delta", 1)
    huf = sprintz_jax.SprintzCodec("delta", 1, entropy="huffman")
    # high-entropy input -> sprintz output incompressible -> verbatim
    x = rng.integers(0, 256, (500, 7)).astype(np.uint8)
    b_plain, b_huf = plain.compress(x), huf.compress(x)
    assert b_huf == b_plain  # zero overhead, byte-identical
    assert not hf.is_container(b_plain)
    np.testing.assert_array_equal(huf.decompress(b_huf), x.reshape(-1))
    # smooth input -> Huffman wins -> container
    y = np.cumsum(rng.integers(-2, 3, (5000, 7)), axis=0).astype(np.uint8)
    c_plain, c_huf = plain.compress(y), huf.compress(y)
    assert len(c_huf) < len(c_plain)
    assert hf.is_container(c_huf)
    np.testing.assert_array_equal(huf.decompress(c_huf), y.reshape(-1))


def test_is_container_strictness(rng):
    import sprintz_jax.entropy.huffman as hf

    for n in (0, 1, 100, 10_007):
        data = rng.integers(0, 17, n).astype(np.uint8)
        for cs in (128, 4096):
            assert hf.is_container(huff_compress(data, chunk_symbols=cs))
        assert hf.is_container(hf._stored_stream(data, 4096))
    # truncation / extension break the exact-length match
    buf = huff_compress((np.arange(10_000) % 9).astype(np.uint8))
    assert hf.is_container(buf)
    assert not hf.is_container(buf[:-1])
    assert not hf.is_container(buf + b"\0")
    assert not hf.is_container(b"")
    assert not hf.is_container(b"\0" * 11)
    # random blobs essentially never validate
    hits = sum(hf.is_container(rng.integers(0, 256, 64).astype(
        np.uint8).tobytes()) for _ in range(200))
    assert hits == 0


