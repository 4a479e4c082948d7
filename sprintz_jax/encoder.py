"""Vectorized Sprintz encoder: JAX device pass + host plan/assembly.

Three stages (SURVEY §7 step 3):
1. Device (jit): forecast all blocks (delta = shifted subtract; FIRE =
   lax.scan), compute per-block/dim widths and zero flags, and bit-pack
   every block into a dense per-block buffer (one-hot matmul, see
   ops/pack.py). Forecaster state does not depend on the RLE/group
   structure, so this is one parallel pass.
2. Host: derive the group/RLE emission plan from the zero flags
   (planner.build_plan) — O(blocks) bookkeeping, no element data touched.
3. Host: assemble the final byte stream (headers via np.packbits, payload
   slices from the dense buffer, run varints, verbatim tail).

Output is byte-identical to the reference/golden encoders.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import config
from .constants import (
    BLOCK_SZ,
    GROUP_SZ_BLOCKS,
    LOWDIM_MAX_NDIMS,
    METADATA_LEN_RLE,
    MIN_DATA_SIZE,
    nbits_sz_bits,
)
from .golden.stream import write_metadata_rle
from .planner import KIND_DATA, KIND_RUN, build_plan, pack_headers
from .models.forecasters import delta_encode, fire_encode
from .ops.bitmath import block_widths_lowdim, block_widths_rowmajor, header_value
from .ops.pack import pack_dims_lowdim, pack_rows_rowmajor
from .utils.shapes import next_bucket, pad_rows


# Dim-major lowdim encode (delta, D*elem_sz in {1,2,4}): same layout
# as decoder.LOWDIM_DMAJOR (no (N, D<=4)-minor tensors). Read at trace
# time; jax.clear_caches() after changing.
LOWDIM_DMAJOR = config.get("SPRINTZ_LOWDIM_DMAJOR") == "1"

# dmajor pack formulation — see decoder.LOWDIM_DMAJOR_IMPL
LOWDIM_DMAJOR_IMPL = config.get("SPRINTZ_LOWDIM_DMAJOR_IMPL")

# Lowdim delta encode pass: "dmajor" (8 dim-major (D, nb) slots),
# "grouped" (G = 128/D blocks folded so every N-scale tensor is
# (c, 8, ~128) full tiles), "legacy".
LOWDIM_ENCODE = config.get(
    "SPRINTZ_LOWDIM_ENCODE",
    default="dmajor" if LOWDIM_DMAJOR else "legacy")

# Flat-param lowdim delta encode: the (N, D<=4) jit param layout pads
# its minor dim to a full tile. "auto" = u8 D in {2,3,4} and u16 d2
# (d1's (N,1) param squeezes free), "all" = every lowdim delta,
# "0" = off.
ENCODE_FLAT = config.get("SPRINTZ_ENCODE_FLAT")



def _encode_lowdim_dmajor(rows: jnp.ndarray, elem_sz: int):
    """Dim-major delta lowdim encode: rows (N, D) narrow uint.

    Returns the _encode_pass contract (widths, hdr, dense,
    width_sums) with widths/hdr as (nb, D) uint8. No small-minor
    tensors: ONE (nb, 8) -> (8, nb) word transpose de-interleaves
    time, sample slots stay separate (D, nb) arrays, and the
    (nb, *) outputs ride u32-word bitcasts.
    """
    from .ops.bitmath import sign_extend, zigzag_encode
    from .ops.pack import (
        pack_fields_lowdim_dmajor,
        pack_fields_lowdim_dynshift,
        pack_rows_from_dmajor,
    )

    pack_fields = (pack_fields_lowdim_dynshift
                   if LOWDIM_DMAJOR_IMPL == "dyn"
                   else pack_fields_lowdim_dmajor)
    eb = 8 * elem_sz
    n, ndims = rows.shape
    nb = n // BLOCK_SZ
    row_b = ndims * elem_sz
    mask = (1 << eb) - 1
    if ndims == 1:
        words = rows.reshape(nb, BLOCK_SZ)
    elif row_b == 2:
        words = jax.lax.bitcast_convert_type(
            rows.astype(jnp.uint8), jnp.uint16).reshape(nb, BLOCK_SZ)
    elif elem_sz == 2:
        words = jax.lax.bitcast_convert_type(
            rows.astype(jnp.uint16), jnp.uint32).reshape(nb, BLOCK_SZ)
    else:
        words = jax.lax.bitcast_convert_type(
            rows.astype(jnp.uint8), jnp.uint32).reshape(nb, BLOCK_SZ)
    wt = jnp.swapaxes(words, -1, -2)  # (8, nb) — the one interleave op
    slots_v = [
        jnp.stack([(wt[r].astype(jnp.uint32) >> (eb * d)) & mask
                   for d in range(ndims)]).astype(jnp.int32)
        for r in range(BLOCK_SZ)
    ]  # 8 x (D, nb)
    prev7 = jnp.pad(slots_v[-1][:, :-1], ((0, 0), (1, 0)))
    slots_e = []
    for r in range(BLOCK_SZ):
        prev = prev7 if r == 0 else slots_v[r - 1]
        slots_e.append(zigzag_encode(
            sign_extend(slots_v[r] - prev, eb), eb))
    orm = slots_e[0]
    for r in range(1, BLOCK_SZ):
        orm = orm | slots_e[r]
    w_dm = block_widths_lowdim(orm, elem_sz)  # (D, nb)
    dense = pack_fields_lowdim_dmajor(slots_e, w_dm, elem_sz)
    widths = pack_rows_from_dmajor(w_dm, 1)  # (nb, D) uint8
    hdr = pack_rows_from_dmajor(header_value(w_dm, eb), 1)
    return widths, hdr, dense, w_dm.sum(axis=0)

def _encode_lowdim_grouped(rows: jnp.ndarray, elem_sz: int):
    """Grouped delta lowdim encode: rows (N, D) narrow uint.

    Same _encode_pass contract as _encode_lowdim_dmajor. G = 128/D
    consecutive blocks fold into the dim axis so every N-scale
    tensor is (c, 8, ~128) — full (8, 128) tiles. Rows ride one u32
    word each (row_b = D*elem_sz <= 4), so the rows<->dim-planes
    conversion is shift/mask, not a lane-poor transpose.
    """
    from .ops.bitmath import sign_extend, zigzag_encode
    from .ops.pack import lowdim_group, pack_dims_lowdim

    eb = 8 * elem_sz
    n, ndims = rows.shape
    nd0 = ndims
    if ndims == 3:  # fold as d4: a zero 4th dim deltas/packs to
        # width 0 and its header/payload columns are sliced off
        rows = jnp.concatenate(
            [rows, jnp.zeros((n, 1), rows.dtype)], axis=1)
        ndims = 4
    nb = n // BLOCK_SZ
    row_b = ndims * elem_sz
    mask = (1 << eb) - 1
    if ndims == 1:
        words = rows.reshape(nb, BLOCK_SZ)
    elif row_b == 2:
        words = jax.lax.bitcast_convert_type(
            rows.astype(jnp.uint8), jnp.uint16).reshape(nb, BLOCK_SZ)
    elif elem_sz == 2:
        words = jax.lax.bitcast_convert_type(
            rows.astype(jnp.uint16), jnp.uint32).reshape(nb, BLOCK_SZ)
    else:
        words = jax.lax.bitcast_convert_type(
            rows.astype(jnp.uint8), jnp.uint32).reshape(nb, BLOCK_SZ)
    g = lowdim_group(ndims)
    pad = (-nb) % g
    if pad:
        words = jnp.concatenate(
            [words, jnp.zeros((pad, BLOCK_SZ), words.dtype)])
    c = (nb + pad) // g
    wg = words.reshape(c, g, BLOCK_SZ).swapaxes(1, 2)  # (c, 8, g)
    if ndims == 1:
        vals = wg.astype(jnp.int32) & mask
    else:
        rep = jnp.repeat(wg.astype(jnp.uint32)[..., None], ndims,
                         -1).reshape(c, BLOCK_SZ, g * ndims)
        sh = jnp.tile(jnp.arange(ndims, dtype=jnp.uint32) * eb, g)
        vals = ((rep >> sh) & jnp.uint32(mask)).astype(jnp.int32)
    # previous row of each block's row 0 = preceding block's row 7
    # (one cheap whole-array shift; everything else is full tiles)
    p = vals[:, BLOCK_SZ - 1].reshape(c * g, ndims)
    prev0 = jnp.concatenate(
        [jnp.zeros((1, ndims), p.dtype), p[:-1]]).reshape(c, g * ndims)
    prev = prev0
    errs = []
    for r in range(BLOCK_SZ):
        cur = vals[:, r]
        errs.append(zigzag_encode(sign_extend(cur - prev, eb), eb))
        prev = cur
    orm = errs[0]
    for r in range(1, BLOCK_SZ):
        orm = orm | errs[r]
    widths_g = block_widths_lowdim(orm, elem_sz)  # (c, g*D)
    dense_g = pack_dims_lowdim(
        jnp.stack(errs, axis=1), widths_g, elem_sz)  # (c, g*D, EB)
    dense = dense_g.reshape(c * g, ndims, 8 * elem_sz)[:nb, :nd0]
    widths = widths_g.reshape(c * g, ndims)[:nb, :nd0]
    hdr = header_value(widths, eb)
    return widths, hdr, dense, widths.sum(axis=1)

def _encode_lowdim_flat(flat: jnp.ndarray, ndims: int, elem_sz: int):
    """Lowdim delta encode from a FLAT (N*D,) narrow param.

    The (N, D<=4) jit PARAMETER layout pads its minor dim to a full
    tile (~32-42x physical bloat). A flat param has no padded N-scale tensor: the
    zigzag delta is one D-element lane shift of the flat stream
    (bit-identical to delta_encode on rows — prev of row 0 is 0),
    and every downstream consumer sees only internal reshapes
    whose layout XLA may choose freely.
    """
    from .ops.pack import pack_dims_lowdim_grouped

    eb = 8 * elem_sz
    mask = (1 << eb) - 1
    x = flat.astype(jnp.int32)
    prev = jnp.pad(x, (ndims, 0))[: x.shape[0]]
    d = (x - prev) & mask
    half = 1 << (eb - 1)
    ds = d - ((d & half) << 1)  # sign-extend the low eb bits
    zz = ((ds << 1) ^ (ds >> 31)) & mask
    nb = x.shape[0] // (BLOCK_SZ * ndims)
    blocks = zz.reshape(nb, BLOCK_SZ, ndims)
    ormask = jnp.bitwise_or.reduce(blocks, axis=1)
    widths = block_widths_lowdim(ormask, elem_sz)
    if 128 % ndims == 0 or ndims == 3:
        dense = pack_dims_lowdim_grouped(blocks, widths, elem_sz)
    else:
        dense = pack_dims_lowdim(blocks, widths, elem_sz)
    hdr = header_value(widths, eb)
    return widths, hdr, dense, widths.sum(axis=1)

@functools.partial(
    jax.jit, static_argnames=("codec", "elem_sz", "lowdim",
                              "flat_ndims"))
def _encode_pass(rows: jnp.ndarray, codec: str, elem_sz: int,
                 lowdim: bool, flat_ndims: int = 0):
    """Device pass: rows (N, D) int32 -> (widths, hdr, dense, wsums).

    N divisible by 8. Returns per-block arrays for all N//8 blocks.
    flat_ndims > 0: rows is the FLAT (N*D,) narrow stream instead
    (lowdim delta only — see _encode_lowdim_flat).
    """
    eb = 8 * elem_sz
    if flat_ndims:
        return _encode_lowdim_flat(rows, flat_ndims, elem_sz)
    if (lowdim and codec == "delta"
            and rows.shape[1] * elem_sz in (1, 2, 3, 4)):
        d = rows.shape[1]
        if LOWDIM_ENCODE == "grouped" and (128 % d == 0 or d == 3):
            return _encode_lowdim_grouped(rows, elem_sz)
        if LOWDIM_ENCODE == "dmajor":
            if d * elem_sz in (1, 2, 4):
                return _encode_lowdim_dmajor(rows, elem_sz)
            # d3 u8: dim-major words need a pow2 row; use the
            # grouped pass (d4 fold) instead of the legacy einsum
            return _encode_lowdim_grouped(rows, elem_sz)
    rows = rows.astype(jnp.int32)  # transferred narrow, computed wide
    if codec == "delta":
        errs = delta_encode(rows, eb)
    else:
        errs = fire_encode(rows, eb, truncate_coeffs=not lowdim)
    nb = rows.shape[0] // BLOCK_SZ
    blocks = errs.reshape(nb, BLOCK_SZ, -1)
    ormask = jnp.bitwise_or.reduce(blocks, axis=1)
    if lowdim:
        widths = block_widths_lowdim(ormask, elem_sz)
        if 128 % rows.shape[1] == 0 or rows.shape[1] == 3:
            # group-folded pack (bit-identical, codec-agnostic):
            # full (8, ~128) tiles instead of minor-D batches —
            # this is the xff-lowdim fast pass;
            # d3 rides the wrapper's d4 fold
            from .ops.pack import pack_dims_lowdim_grouped

            dense = pack_dims_lowdim_grouped(blocks, widths, elem_sz)
        else:
            dense = pack_dims_lowdim(blocks, widths, elem_sz)
    else:
        widths = block_widths_rowmajor(ormask, elem_sz)
        from .ops import pack as _pack

        dense = pack_rows_rowmajor(
            blocks, widths, elem_sz,
            pair=_pack.UNPACK_PAIR and elem_sz == 1)
    hdr = header_value(widths, eb)
    width_sums = widths.sum(axis=1)
    return widths, hdr, dense, width_sums


def compress(
    flat: np.ndarray,
    ndims: int,
    codec: str = "delta",
    elem_sz: int | None = None,
    force_layout: str | None = None,
) -> bytes:
    """Compress a flat row-major stream; byte-identical to the golden codec."""
    flat = np.ascontiguousarray(flat)
    elem_sz = flat.dtype.itemsize if elem_sz is None else elem_sz
    n = flat.size
    hdr_bits = nbits_sz_bits(elem_sz)

    if force_layout is None:
        lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    else:
        lowdim = force_layout == "lowdim"

    if n < MIN_DATA_SIZE:
        return write_metadata_rle(0, n, ndims) + flat.tobytes()

    block_elems = BLOCK_SZ * ndims
    nb_max = n // block_elems
    nb_pad = next_bucket(nb_max)
    rows = pad_rows(
        flat[: nb_max * block_elems].reshape(-1, ndims), nb_pad * BLOCK_SZ)

    # Precedence: an EXPLICIT SPRINTZ_LOWDIM_ENCODE setting
    # disables the flat auto-route so pass A/Bs measure what they ask
    # for; ENCODE_FLAT="all" still forces flat everywhere.
    use_flat = (lowdim and codec == "delta"
                and ENCODE_FLAT != "0"
                and (ENCODE_FLAT == "all"
                     or (config.get("SPRINTZ_LOWDIM_ENCODE") is None
                         and ((elem_sz == 1 and ndims in (2, 3, 4))
                              or (elem_sz == 2 and ndims == 2)))))
    if use_flat:
        widths, hdr, dense, width_sums = _encode_pass(
            jnp.asarray(rows.reshape(-1)), codec, elem_sz, lowdim,
            flat_ndims=ndims)
    else:
        widths, hdr, dense, width_sums = _encode_pass(
            jnp.asarray(rows), codec, elem_sz, lowdim)
    widths_np = np.asarray(widths).astype(np.int32)
    hdr_np = np.asarray(hdr).astype(np.uint8)
    dense_np = np.asarray(dense)
    zero_flags = np.asarray(width_sums)[:nb_max] == 0

    run_cmp_allows_equal = codec == "xff" and not lowdim
    plan = build_plan(zero_flags, n, ndims, run_cmp_allows_equal)
    stream = assemble_stream(
        plan, widths_np, hdr_np, dense_np, ndims, elem_sz, lowdim,
        flat[n - plan.remaining_elems:],
        wsums=np.asarray(width_sums, dtype=np.int32))
    return stream


def compress_batch(
    streams: np.ndarray,
    codec: str = "delta",
    force_layout: str | None = None,
) -> list[bytes]:
    """Compress S same-shape streams in one device pass.

    streams: (S, total_rows, D). The forecaster/pack pass is vmapped over
    the batch (FIRE's scan then runs S*D lanes wide — the throughput axis,
    SURVEY §5), while per-stream planning/assembly stays on host. Each
    returned stream is byte-identical to compressing it alone.
    """
    streams = np.ascontiguousarray(streams)
    S, nrows, ndims = streams.shape
    elem_sz = streams.dtype.itemsize
    n = nrows * ndims
    if force_layout is None:
        lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    else:
        lowdim = force_layout == "lowdim"
    if n < MIN_DATA_SIZE:
        return [write_metadata_rle(0, n, ndims) + s.tobytes()
                for s in streams]

    nb_max = nrows // BLOCK_SZ
    nb_pad = next_bucket(nb_max)
    rows = np.zeros((S, nb_pad * BLOCK_SZ, ndims), dtype=streams.dtype)
    rows[:, : nb_max * BLOCK_SZ] = streams[:, : nb_max * BLOCK_SZ]

    batched = jax.jit(
        jax.vmap(lambda r: _encode_pass.__wrapped__(
            r, codec, elem_sz, lowdim)),
        static_argnames=())
    widths, hdr, dense, width_sums = batched(jnp.asarray(rows))
    widths_np = np.asarray(widths).astype(np.int32)
    hdr_np = np.asarray(hdr).astype(np.uint8)
    dense_np = np.asarray(dense)
    zero_np = np.asarray(width_sums) == 0

    out = []
    run_cmp_allows_equal = codec == "xff" and not lowdim
    for s in range(S):
        plan = build_plan(zero_np[s, :nb_max], n, ndims,
                          run_cmp_allows_equal)
        out.append(assemble_stream(
            plan, widths_np[s], hdr_np[s], dense_np[s], ndims, elem_sz,
            lowdim, streams[s].reshape(-1)[n - plan.remaining_elems:],
            wsums=np.asarray(width_sums[s], dtype=np.int32)))
    return out


def assemble_stream(plan, widths_np, hdr_np, dense_np, ndims, elem_sz,
                    lowdim, tail: np.ndarray, wsums=None) -> bytes:
    """Final stream assembly.

    Prefers the native C++ assembler (native/sprintz_host.cpp); the numpy
    path below computes every byte's destination with index arithmetic:
    group g's header precedes slots 2g, 2g+1; slot payload lengths are
    8*row_nbytes (rowmajor), sum(widths) (lowdim), or varint sizes.
    """
    from .native_host import assemble_stream_native

    native = assemble_stream_native(
        plan.kinds, plan.values, plan.ngroups, plan.remaining_elems,
        widths_np, hdr_np, dense_np, ndims, elem_sz, lowdim,
        tail.tobytes(), wsums=wsums)
    if native is not None:
        return native
    return _assemble_stream_np(
        plan, widths_np, hdr_np, dense_np, ndims, elem_sz, lowdim, tail)


def _assemble_stream_np(plan, widths_np, hdr_np, dense_np, ndims, elem_sz,
                        lowdim, tail: np.ndarray) -> bytes:
    hdr_bits = nbits_sz_bits(elem_sz)
    total_header_bytes = (ndims * hdr_bits * GROUP_SZ_BLOCKS + 7) // 8

    kinds = plan.kinds
    values = plan.values
    nslots = plan.nslots
    data_mask = kinds == KIND_DATA
    run_mask = kinds == KIND_RUN
    data_vals = values[data_mask]

    # per-slot payload lengths
    slot_len = np.ones(nslots, dtype=np.int64)  # run0 -> 1 byte
    if lowdim:
        block_payload = widths_np.sum(axis=1).astype(np.int64)
    else:
        row_nbytes = (widths_np.sum(axis=1) + 7) // 8
        block_payload = (BLOCK_SZ * row_nbytes).astype(np.int64)
    slot_len[data_mask] = block_payload[data_vals]
    slot_len[run_mask] = 1 + (values[run_mask] > 0x7F)

    # output offsets: META + headers before/within + payloads before
    cum_payload = np.concatenate([[0], np.cumsum(slot_len)])
    slot_off = (METADATA_LEN_RLE
                + total_header_bytes * (np.arange(nslots) // GROUP_SZ_BLOCKS + 1)
                + cum_payload[:-1])
    total = int(slot_off[-1] + slot_len[-1]) if nslots else METADATA_LEN_RLE
    out = np.zeros(total + tail.nbytes, dtype=np.uint8)
    out[:METADATA_LEN_RLE] = np.frombuffer(
        write_metadata_rle(plan.ngroups, plan.remaining_elems, ndims),
        dtype=np.uint8)

    # headers
    slot_headers = np.zeros((nslots, ndims), dtype=np.uint8)
    slot_headers[data_mask] = hdr_np[data_vals]
    header_bytes = pack_headers(slot_headers, hdr_bits)
    hdr_off = (slot_off[::GROUP_SZ_BLOCKS] - total_header_bytes)
    out[hdr_off[:, None] + np.arange(total_header_bytes)[None, :]] = header_bytes

    # run varints
    run_off = slot_off[run_mask]
    run_val = values[run_mask].astype(np.int64)
    two = run_val > 0x7F
    out[run_off] = (run_val & 0x7F) | (two.astype(np.int64) << 7)
    out[run_off[two] + 1] = run_val[two] >> 7

    # data payloads: build flat (out_idx, src_idx) index arrays
    if data_vals.size:
        doff = slot_off[data_mask]
        if lowdim:
            # units are (block, dim) sections of widths[b, d] bytes
            w = widths_np[data_vals].astype(np.int64)  # (ndata, D)
            unit_len = w.reshape(-1)
            unit_out = (np.repeat(doff, ndims)
                        + (np.cumsum(w, axis=1) - w).reshape(-1))
            unit_src = (data_vals[:, None] * ndims
                        + np.arange(ndims)[None, :]).reshape(-1) * dense_np.shape[2]
            nz = unit_len > 0
            unit_len, unit_out, unit_src = unit_len[nz], unit_out[nz], unit_src[nz]
        else:
            rb = row_nbytes[data_vals].astype(np.int64)  # (ndata,)
            # units are rows: 8 per block, rb bytes each
            unit_len = np.repeat(rb, BLOCK_SZ)
            unit_out = (np.repeat(doff, BLOCK_SZ)
                        + np.tile(np.arange(BLOCK_SZ), rb.size) * unit_len)
            unit_src = ((data_vals[:, None] * BLOCK_SZ
                         + np.arange(BLOCK_SZ)[None, :]).reshape(-1)
                        * dense_np.shape[2])
            nz = unit_len > 0
            unit_len, unit_out, unit_src = unit_len[nz], unit_out[nz], unit_src[nz]
        tot = int(unit_len.sum())
        if tot:
            starts = np.cumsum(unit_len) - unit_len
            q = np.arange(tot) - np.repeat(starts, unit_len)  # pos within unit
            out_idx = np.repeat(unit_out, unit_len) + q
            src_idx = np.repeat(unit_src, unit_len) + q
            out[out_idx] = dense_np.reshape(-1)[src_idx]

    if tail.nbytes:
        out[total:] = np.frombuffer(tail.tobytes(), dtype=np.uint8)
    return out.tobytes()
