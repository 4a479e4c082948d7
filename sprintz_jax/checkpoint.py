"""Seekable streams: checkpoint sidecars for mid-stream parallel decode.

The reference format has no runtime checkpointing — predictor state is
never serialized and decode always replays from stream start (SURVEY §5);
``jump()`` (online.hpp:126-132) exists but is unused. This module supplies
that capability without changing the byte format: an optional *sidecar*
records, every ``every_groups`` groups, the group's byte offset, output
row offset, and the forecaster state entering it. With a sidecar you can:

- decode any row range without replaying the stream prefix, and
- decode a long stream chunk-parallel (each worker enters at a checkpoint).

State layout per dim: delta -> prev value; FIRE -> (prev value,
prev delta, coefficient counter).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import (
    BLOCK_SZ,
    GROUP_SZ_BLOCKS,
    LOWDIM_MAX_NDIMS,
    METADATA_LEN_RLE,
    MIN_DATA_SIZE,
    nbits_sz_bits,
)
from .golden.stream import read_metadata_rle


@dataclasses.dataclass
class Sidecar:
    every_groups: int
    codec: str
    elem_sz: int
    ndims: int
    byte_offsets: np.ndarray  # (nckpt,) group start offsets into the stream
    row_offsets: np.ndarray  # (nckpt,) first output row of the group
    states: np.ndarray  # (nckpt, state_dim, ndims) int32

    def to_bytes(self) -> bytes:
        head = np.array(
            [self.every_groups, {"delta": 0, "xff": 1}[self.codec],
             self.elem_sz, self.ndims, len(self.byte_offsets)],
            dtype=np.int64).tobytes()
        return (head + self.byte_offsets.astype(np.int64).tobytes()
                + self.row_offsets.astype(np.int64).tobytes()
                + self.states.astype(np.int32).tobytes())

    @classmethod
    def from_bytes(cls, buf: bytes) -> "Sidecar":
        head = np.frombuffer(buf, dtype=np.int64, count=5)
        every, codec_id, elem_sz, ndims, n = (int(v) for v in head)
        codec = "delta" if codec_id == 0 else "xff"
        off = 40
        bo = np.frombuffer(buf, dtype=np.int64, count=n, offset=off)
        off += 8 * n
        ro = np.frombuffer(buf, dtype=np.int64, count=n, offset=off)
        off += 8 * n
        sdim = 1 if codec == "delta" else 3
        st = np.frombuffer(buf, dtype=np.int32, count=n * sdim * ndims,
                           offset=off).reshape(n, sdim, ndims)
        return cls(every, codec, elem_sz, ndims, bo.copy(), ro.copy(),
                   st.copy())


def compress_with_sidecar(
    flat: np.ndarray,
    ndims: int,
    codec: str = "delta",
    every_groups: int = 16,
) -> tuple[bytes, Sidecar]:
    """Encode (byte-exact reference stream) + build a checkpoint sidecar.

    ``every_groups=16`` keeps the chunk-parallel decode's per-chunk block
    count at 32 (fully covered by one unrolled FIRE scan step); it beat
    64 in an earlier device A/B. Sidecar overhead at 16 is ~0.9% of an
    8 MiB u8 d64 stream.
    """
    import jax.numpy as jnp

    from . import encoder
    from .models.forecasters import fire_encode_with_states

    flat = np.ascontiguousarray(flat)
    elem_sz = flat.dtype.itemsize
    lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    stream = encoder.compress(flat, ndims, codec=codec)

    # group byte offsets + first-block indices from the emission plan
    ngroups, remaining, _ = read_metadata_rle(stream)
    idx = _group_index(stream, ngroups, ndims, elem_sz, lowdim)
    ck = np.arange(0, ngroups, every_groups)

    first_block = idx.first_block_of_group[ck]
    if codec == "delta":
        # state = previous row (zeros at stream start)
        rows = flat.reshape(-1, ndims)
        states = np.zeros((len(ck), 1, ndims), dtype=np.int32)
        for i, fb in enumerate(first_block.tolist()):
            if fb > 0:
                states[i, 0] = rows[fb * BLOCK_SZ - 1]
    else:
        nb_max = flat.size // (BLOCK_SZ * ndims)
        rows = jnp.asarray(
            flat[: nb_max * BLOCK_SZ * ndims].reshape(-1, ndims), jnp.int32)
        _, carries = fire_encode_with_states(
            rows, 8 * elem_sz, truncate_coeffs=not lowdim)
        carries = np.asarray(carries)  # (nb, 3, D), state BEFORE each block
        states = carries[np.minimum(first_block, nb_max - 1)].astype(np.int32)
        states[first_block == 0] = 0

    return stream, Sidecar(
        every_groups=every_groups, codec=codec, elem_sz=elem_sz,
        ndims=ndims,
        byte_offsets=idx.group_offsets[ck],
        row_offsets=idx.first_row_of_group[ck],
        states=states)


@dataclasses.dataclass
class _GroupIndex:
    group_offsets: np.ndarray
    first_row_of_group: np.ndarray
    first_block_of_group: np.ndarray
    total_rows: int


def _group_index(buf: bytes, ngroups: int, ndims: int, elem_sz: int,
                 lowdim: bool = False) -> _GroupIndex:
    """Byte/row/block offsets of every group (one header-walk pass)."""
    hdr_bits = nbits_sz_bits(elem_sz)
    elem_bits = 8 * elem_sz
    total_header_bytes = (ndims * hdr_bits * GROUP_SZ_BLOCKS + 7) // 8
    from .planner import unpack_headers

    data = np.frombuffer(buf, dtype=np.uint8)
    offs = np.zeros(ngroups, dtype=np.int64)
    rows = np.zeros(ngroups, dtype=np.int64)
    blocks = np.zeros(ngroups, dtype=np.int64)
    pos = METADATA_LEN_RLE
    row = 0
    blk = 0
    for g in range(ngroups):
        offs[g], rows[g], blocks[g] = pos, row, blk
        hdr = unpack_headers(
            data[pos : pos + total_header_bytes][None, :], 1, ndims, hdr_bits)
        pos += total_header_bytes
        for b in range(GROUP_SZ_BLOCKS):
            w = hdr[b].astype(np.int64)
            w = np.where(w == elem_bits - 1, elem_bits, w)
            wsum = int(w.sum())
            if wsum == 0:
                low = buf[pos]
                pos += 1
                length = low & 0x7F
                if low & 0x80:
                    length |= buf[pos] << 7
                    pos += 1
                row += length * BLOCK_SZ
                blk += length
            else:
                pos += wsum if lowdim else BLOCK_SZ * ((wsum + 7) // 8)
                row += BLOCK_SZ
                blk += 1
    return _GroupIndex(offs, rows, blocks, row)


@dataclasses.dataclass
class _ParallelPrep:
    """Host-side tensors for one _decode_pass_chunks launch."""

    dense_c: np.ndarray  # (C, nb_pad, ...) u8 payload per chunk
    widths_c: np.ndarray  # (C, nb_pad, D) i32
    local_rows: np.ndarray  # (C, nb_pad) i32 block rows within chunk
    states: np.ndarray  # (C, 3, D) i32 forecaster state per chunk
    rows_pad: int
    contiguous: bool
    lowdim: bool
    chunk_rows: np.ndarray  # (C,) true rows per chunk
    tail_offset: int
    remaining: int


def _parallel_prep(buf: bytes, sidecar: Sidecar) -> _ParallelPrep | None:
    """Shared prep for the chunk-parallel decode: walk, gather, and
    regroup payload blocks by sidecar chunk. None -> caller should fall
    back to the serial decoder (degenerate stream/sidecar)."""
    from . import decoder
    from .utils.shapes import next_bucket

    ngroups, remaining, ndims = read_metadata_rle(buf)
    assert ndims == sidecar.ndims
    elem_sz = sidecar.elem_sz
    if ngroups == 0:
        return None
    lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    idx = decoder.walk_headers_parallel(
        buf, ngroups, ndims, elem_sz, sidecar.byte_offsets,
        sidecar.row_offsets, sidecar.every_groups, lowdim=lowdim)
    ndata = idx.widths.shape[0]
    if ndata == 0 or len(sidecar.byte_offsets) <= 1:
        return None
    dense = decoder.gather_payloads(buf, idx, ndims, elem_sz, lowdim)

    C = len(sidecar.byte_offsets)
    row_start = sidecar.row_offsets.astype(np.int64)
    chunk_rows = np.diff(np.append(row_start, idx.total_rows))
    if (np.any(chunk_rows < 0) or row_start[0] != 0
            or np.any(np.diff(sidecar.byte_offsets) <= 0)):
        from .errors import CorruptStreamError

        raise CorruptStreamError(
            "sidecar inconsistent with stream: checkpoint offsets must be "
            "strictly increasing and start at row 0")
    chunk_of_block = (np.searchsorted(
        sidecar.byte_offsets, idx.payload_offsets, side="right") - 1)
    counts = np.bincount(chunk_of_block, minlength=C)
    nb_pad = next_bucket(max(int(counts.max()), 1))
    contiguous = idx.total_rows == ndata * BLOCK_SZ
    rows_pad = (nb_pad * BLOCK_SZ if contiguous
                else next_bucket(max(int(chunk_rows.max()), BLOCK_SZ)))

    dense_c = np.zeros((C, nb_pad) + dense.shape[1:], np.uint8)
    widths_c = np.zeros((C, nb_pad, ndims), np.int32)
    local_rows = np.full((C, nb_pad), rows_pad + BLOCK_SZ, np.int32)
    order = np.argsort(chunk_of_block, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    for c in range(C):
        seg = order[starts[c] : starts[c + 1]]
        n = len(seg)
        dense_c[c, :n] = dense[seg]
        widths_c[c, :n] = idx.widths[seg]
        local_rows[c, :n] = idx.out_rows[seg] - row_start[c]

    states = np.zeros((C, 3, ndims), np.int32)
    states[:, : sidecar.states.shape[1]] = sidecar.states
    return _ParallelPrep(dense_c, widths_c, local_rows, states, rows_pad,
                         contiguous, lowdim, chunk_rows, idx.tail_offset,
                         remaining)


def decompress_parallel(buf: bytes, sidecar: Sidecar) -> np.ndarray:
    """Chunk-parallel decode of a sidecar-equipped stream.

    Splits the stream at the sidecar's checkpoints and decodes every
    chunk concurrently in one vmapped device pass
    (decoder._decode_pass_chunks) — each chunk enters at its recorded
    forecaster state, so FIRE's serial recurrence only spans one chunk
    instead of the whole stream. Byte format unchanged (the sidecar is
    optional metadata); output equals ``decoder.decompress``.
    Returns flat elements.
    """
    import jax.numpy as jnp

    from . import decoder

    elem_sz = sidecar.elem_sz
    udt = np.uint8 if elem_sz == 1 else np.uint16
    prep = _parallel_prep(buf, sidecar)
    if prep is None:
        return decoder.decompress(buf, sidecar.codec, elem_sz)

    if decoder._decode_flat_ok(prep.lowdim):
        C, nb, d1, d2 = prep.dense_c.shape
        vals = decoder._decode_pass_chunks_flat(
            jnp.asarray(np.ascontiguousarray(prep.dense_c).reshape(-1)),
            jnp.asarray(np.ascontiguousarray(prep.widths_c).reshape(-1)),
            jnp.asarray(prep.local_rows), jnp.asarray(prep.states),
            sidecar.codec, elem_sz, prep.lowdim, prep.rows_pad,
            prep.contiguous, C, nb, d1, d2, prep.widths_c.shape[2])
    else:
        vals = decoder._decode_pass_chunks(
            jnp.asarray(prep.dense_c), jnp.asarray(prep.widths_c),
            jnp.asarray(prep.local_rows), jnp.asarray(prep.states),
            sidecar.codec, elem_sz, prep.lowdim, prep.rows_pad,
            prep.contiguous)
    vals = np.asarray(vals)
    C = prep.dense_c.shape[0]
    body = np.concatenate(
        [vals[c, : prep.chunk_rows[c]] for c in range(C)]).astype(udt)
    tail = np.frombuffer(buf, dtype=udt, count=prep.remaining,
                         offset=prep.tail_offset)
    return np.concatenate([body.reshape(-1), tail])


def decode_range(buf: bytes, sidecar: Sidecar, start_row: int, nrows: int
                 ) -> np.ndarray:
    """Decode rows [start_row, start_row + nrows) without replaying the
    stream prefix: seek to the last checkpoint at or before start_row,
    decode forward from there, slice."""
    from . import decoder

    ngroups, remaining, ndims = read_metadata_rle(buf)
    assert ndims == sidecar.ndims
    lowdim = ndims <= LOWDIM_MAX_NDIMS[sidecar.elem_sz]
    k = int(np.searchsorted(sidecar.row_offsets, start_row, side="right")) - 1
    k = max(k, 0)
    byte_off = int(sidecar.byte_offsets[k])
    row_off = int(sidecar.row_offsets[k])
    groups_left = ngroups - k * sidecar.every_groups

    idx = decoder.walk_headers(
        buf, groups_left, ndims, sidecar.elem_sz, start=byte_off,
        lowdim=lowdim)
    vals = decoder.decode_indexed(
        buf, idx, ndims, sidecar.elem_sz, sidecar.codec,
        init_state=sidecar.states[k], lowdim=lowdim)
    # append whole rows from the verbatim tail if the range extends past
    # the block-coded region
    lo = start_row - row_off
    if lo + nrows > vals.shape[0] and remaining >= ndims:
        udt = np.uint8 if sidecar.elem_sz == 1 else np.uint16
        tail = np.frombuffer(
            buf, dtype=udt, count=(remaining // ndims) * ndims,
            offset=idx.tail_offset).reshape(-1, ndims)
        vals = np.concatenate([vals, tail])
    return vals[lo : lo + nrows]
