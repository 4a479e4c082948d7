"""Vectorized Sprintz decoder: host header walk + JAX device reconstruct.

The compressed layout only reveals payload sizes through the group headers,
so offset recovery is a cheap sequential walk (O(groups), header bytes
only — SURVEY §7 "decoder offset recovery"). Everything heavy then runs in
one device pass:

- gather packed payload rows into a dense (ndata, 8, MAXB) buffer,
- extract per-dim fields (shift/mask, ops/pack.py),
- scatter block errors into the full row timeline (runs = zero errors),
- reconstruct values: delta = one cumulative sum; FIRE = block scan.

Runs thus need no memrep: a zero-error row IS the run semantics for both
forecasters, which is exactly how the reference decoder treats them
(sprintz_delta_rle.cpp:646-682, sprintz_xff_rle.cpp:824-955).
"""

from __future__ import annotations

import dataclasses
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
from .golden.stream import read_metadata_rle
from .planner import unpack_headers
from .models.forecasters import delta_decode, fire_decode
from .ops.pack import unpack_dims_lowdim, unpack_rows_rowmajor
from .utils.shapes import next_bucket, pad_rows


# max decoded bytes per device pass on the contiguous path; longer
# streams are tiled with forecaster-state carry. 8 MiB was the knee of
# an earlier device's working set; the H100 sweep is ROADMAP Queue 1
# item 8.
CHUNK_OUT_BYTES = 8 << 20

# Dim-major lowdim decode (delta, D*elem_sz in {1,2,4}): all device
# tensors keep the sample axis minor instead of a (N, D<=4)-minor
# layout that pads its lane dim. Read at trace time; jax.clear_caches()
# after changing in-process.
LOWDIM_DMAJOR = config.get("SPRINTZ_LOWDIM_DMAJOR") == "1"

# dmajor extraction formulation: "dyn" = per-element variable-shift
# window extraction (~10 ops/sample-slot); "strata" = width-stratified
# static shifts (~25 ops/slot).
LOWDIM_DMAJOR_IMPL = config.get("SPRINTZ_LOWDIM_DMAJOR_IMPL")

# Lowdim delta decode pass: "legacy" (batched einsum + (N, D) prefix),
# "dmajor" (8 dim-major (D, nb) slots), "grouped" (G = 128/D blocks
# folded so every N-scale tensor is (c, 8, ~128) — full tiles), "auto"
# (grouped when D divides 128, legacy for d3, where the group padding
# costs more than it saves).
LOWDIM_PASS = config.get("SPRINTZ_LOWDIM_PASS")

# Runs-stream timeline materialization in _decode_pass: "auto" and
# "gather" gather whole unpacked blocks onto the timeline (block starts
# are 8-aligned, so it is a major-axis gather with full minor tiles);
# "dgather" gathers the PACKED u8 payload onto the timeline BEFORE
# unpacking (1/8 the gathered bytes, but the unpack weight tensor grows
# to timeline blocks); "ngather" gathers errors narrowed to the element
# width; "scatter" is the legacy (ndata*8, D) row scatter.
RUNS_TIMELINE = config.get("SPRINTZ_RUNS_TIMELINE")

# Block-folded rowmajor delta decode: fold G = 128/D consecutive blocks
# into one 128-lane virtual block so every N-scale tensor is full-lane.
# Off by default; force with SPRINTZ_ROWMAJOR_FOLD=1/0.
ROWMAJOR_FOLD = config.get("SPRINTZ_ROWMAJOR_FOLD") == "1"

# Dense-buffer width bucketing on the rowmajor decode path ("pow2" or
# "mult8"). The unpack weight tensor (c, D, maxb) scales with maxb, but
# pow2 rounds a stream's rb_max ~ 40 bytes straight back to 64. mult8
# buckets to multiples of 8 (more jit variants, up to 1.6x smaller
# weights).
MAXB_BUCKET = config.get("SPRINTZ_MAXB_BUCKET")

# Grouped prefix finish formulation: "v1" adds the group offsets in
# (c, 8, g, D) layout — an N-scale minor-D tensor that pads its lane
# dim for the add+mask; "v2" keeps the N-scale add+mask in the full-lane
# (c, 8, g*D) layout (the g-axis offset prefix becomes log2(g) static
# lane shifts) and only the final narrow-u8 output reorder touches a
# minor-D shape.
GROUPED_FINISH = config.get("SPRINTZ_GROUPED_FINISH")

# d3 grouped decode fold: "fold4" appends a zero-width 4th dim and
# runs the d4 pass (g=32, 25% wasted lanes+work); "native" folds g=42
# blocks directly (g*D = 126 of 128 lanes, no fake dim). Encode always
# folds as d4 (its row<->u32 word bitcast needs row_b in {1,2,4}).
LOWDIM_D3 = config.get("SPRINTZ_LOWDIM_D3")

# Flat-param contiguous decode: the (nb, 8, maxb<=32) u8 dense and
# (nb, D) u8 widths jit PARAMETERS would pad their minor dims at rest;
# passing them as flat 1-D arrays and reshaping inside jit avoids that.
# "auto" = every contiguous pass, "all" (same, plus forces it where auto
# would skip), "0".
DECODE_FLAT = config.get("SPRINTZ_DECODE_FLAT")


def _decode_flat_ok(lowdim: bool) -> bool:
    return DECODE_FLAT in ("auto", "all")


def _lowdim_pass(codec: str, ndims: int, elem_sz: int) -> str:
    """Which fused lowdim delta pass applies (falls back to legacy)."""
    if codec != "delta":
        return "legacy"
    if LOWDIM_PASS == "grouped":
        return "grouped"
    if LOWDIM_PASS == "dmajor" and ndims * elem_sz in (1, 2, 4):
        return "dmajor"
    if LOWDIM_PASS == "auto" and 128 % ndims == 0:
        return "grouped"  # d3 stays legacy (see LOWDIM_PASS)
    return "legacy"


def _grouped_unpack_ok(ndims: int) -> bool:
    """Use the group-folded lowdim unpack (bit-identical, codec-agnostic:
    it only reshapes the einsum batch to full (8, ~128) tiles)? Applies
    to xff too — the delta-only gate above is about the fused PREFIX, not
    the unpack."""
    if LOWDIM_PASS == "grouped":  # explicit force allows the d3 folds
        return 128 % ndims == 0 or ndims == 3
    return LOWDIM_PASS == "auto" and 128 % ndims == 0


def _dmajor_ok(codec: str, ndims: int, elem_sz: int) -> bool:
    return _lowdim_pass(codec, ndims, elem_sz) == "dmajor"



def _pair_ok(elem_sz):
    """Paired-dim rowmajor unpack (halved weight tensor) is exact
    only for u8 fields (pairs <= 16 bits; ops/pack.py UNPACK_PAIR)."""
    from .ops import pack as _pack

    return _pack.UNPACK_PAIR and elem_sz == 1

def _unpack_lowdim_best(dense, widths):
    """Lowdim field extraction with the fastest bit-identical
    formulation: group-folded when D divides 128, legacy einsum
    otherwise. Codec-independent."""
    from .ops.pack import unpack_dims_lowdim_grouped

    if _grouped_unpack_ok(widths.shape[-1]):
        return unpack_dims_lowdim_grouped(dense, widths)
    return unpack_dims_lowdim(dense, widths)

def _decode_lowdim_dmajor(dense, widths, elem_sz, state=None):
    """(nb, D, EB) u8 + (nb, D) widths -> ((N, D) narrow, (D,) last).

    No small-minor tensors anywhere: the 8 sample slots stay
    separate (D, nb) arrays, the block prefix decomposes into 8
    static intra-block adds + ONE (D, nb) cross-block cumsum, and
    the only interleave is the u32-word transpose inside
    interleave_rows_dmajor.
    """
    from .ops.bitmath import zigzag_decode
    from .ops.pack import (
        interleave_rows_dmajor,
        unpack_dims_lowdim_dmajor,
        unpack_dims_lowdim_dynshift,
    )

    eb = 8 * elem_sz
    unpack = (unpack_dims_lowdim_dynshift
              if LOWDIM_DMAJOR_IMPL == "dyn"
              else unpack_dims_lowdim_dmajor)
    slots = unpack(dense, widths)  # 8 x (D, nb)
    intra = []
    run = None
    for r in range(BLOCK_SZ):
        d_r = zigzag_decode(slots[r], eb)
        run = d_r if run is None else run + d_r
        intra.append(run)
    block_sums = intra[-1]
    offs = jnp.cumsum(block_sums, axis=-1, dtype=jnp.int32) - block_sums
    if state is not None:
        offs = offs + state[:, None]
    mask = (1 << eb) - 1
    vals = [(x + offs) & mask for x in intra]
    return interleave_rows_dmajor(vals, elem_sz), vals[-1][:, -1]

def _grouped_prefix_finish(deltas, elem_sz, ndims, last_block, state):
    """Shared tail of the grouped lowdim delta passes.

    deltas: (c, 8, g*D) int32 signed per-dim deltas in grouped
    layout ([c, r, g*D+d] = dim d of row r of block c*g+g). Returns
    ((c*g*8, D) narrow rows, (D,) int32 last decoded row), where
    ``last_block`` indexes the block whose row 7 is "last".
    """
    eb = 8 * elem_sz
    c, _, gd = deltas.shape
    g = gd // ndims
    mask = (1 << eb) - 1
    narrow = jnp.uint8 if elem_sz == 1 else jnp.uint16
    intra = jnp.cumsum(deltas, axis=1)  # 8 static adds
    if GROUPED_FINISH == "v2":
        # full-lane finish: every N-scale op stays (c, 8, g*D)
        bs = intra[:, -1]  # (c, g*D) inclusive block sums
        # inclusive prefix over the g axis (stride-D lanes):
        # log2(g) static lane shifts (Hillis-Steele), exact int32
        incl = bs
        sh = 1
        while sh < g:
            s = sh * ndims
            incl = incl + jnp.pad(incl, ((0, 0), (s, 0)))[:, :-s]
            sh <<= 1
        offs_lane = incl - bs  # exclusive over g, per dim lane
        chunk_tot = incl[:, (g - 1) * ndims:]  # (c, D) per-chunk sum
        offs_c = jnp.cumsum(chunk_tot, axis=0) - chunk_tot  # (c, D)
        if state is not None:
            offs_c = offs_c + state[None, :]
        offs_full = offs_lane + jnp.tile(offs_c, (1, g))  # (c, g*D)
        vals = (intra + offs_full[:, None, :]) & mask  # full-lane
        lb_g = last_block % g
        last = jax.lax.dynamic_slice(
            vals[last_block // g, BLOCK_SZ - 1],
            (lb_g * ndims,), (ndims,))
        out = vals.astype(narrow).reshape(c, BLOCK_SZ, g, ndims)
        return out.swapaxes(1, 2).reshape(-1, ndims), last
    bs = intra[:, -1].reshape(c, g, ndims)  # block sums
    offs_g = jnp.cumsum(bs, axis=1)  # inclusive over g
    chunk_tot = offs_g[:, -1]  # (c, D)
    offs_c = jnp.cumsum(chunk_tot, axis=0) - chunk_tot  # exclusive
    offs = (offs_g - bs) + offs_c[:, None]  # (c, g, D) exclusive
    if state is not None:
        offs = offs + state[None, None, :]
    vals = (intra.reshape(c, BLOCK_SZ, g, ndims) + offs[:, None]) & mask
    last = vals[last_block // g, BLOCK_SZ - 1, last_block % g]  # (D,)
    out = vals.astype(narrow)
    return out.swapaxes(1, 2).reshape(-1, ndims), last

def _decode_lowdim_grouped(dense, widths, elem_sz, state=None):
    """(nb, D, EB) u8 + (nb, D) widths -> ((N, D) narrow, (D,) last).

    Group-folded lowdim delta pass: G = ~128/D consecutive blocks
    fold into the einsum's dim axis, so every tensor that scales
    with N is (c, 8, G*D~128) — full lanes AND full sublanes (the
    legacy pass runs minor-dim D<=4; dmajor runs second-minor D).
    The cross-block prefix decomposes into 8 static intra-block
    adds, a per-group cumsum over g, and a per-chunk cumsum over c
    (both on N/8-scale tensors).
    """
    from .ops.bitmath import zigzag_decode
    from .ops.pack import lowdim_group, unpack_dims_lowdim

    eb = 8 * elem_sz
    nb, ndims, ebytes = dense.shape
    nd0 = ndims
    if ndims == 3 and LOWDIM_D3 != "native":
        # 3 does not divide 128: fold as d4 with a zero-width 4th
        # dim (zero deltas -> the prefix carries 0). "native" skips
        # the fake dim and folds g=42 blocks (126 of 128 lanes).
        dense = jnp.concatenate(
            [dense, jnp.zeros((nb, 1, ebytes), dense.dtype)], axis=1)
        widths = jnp.concatenate(
            [widths, jnp.zeros((nb, 1), widths.dtype)], axis=1)
        if state is not None:
            state = jnp.concatenate(
                [state, jnp.zeros((1,), state.dtype)])
        ndims = 4
    g = lowdim_group(ndims)
    pad = (-nb) % g
    if pad:
        dense = jnp.concatenate(
            [dense, jnp.zeros((pad, ndims, ebytes), dense.dtype)])
        widths = jnp.concatenate(
            [widths, jnp.zeros((pad, ndims), widths.dtype)])
    c = (nb + pad) // g
    errs = unpack_dims_lowdim(
        dense.reshape(c, g * ndims, ebytes).astype(jnp.int32),
        widths.reshape(c, g * ndims).astype(jnp.int32))  # (c, 8, g*D)
    deltas = zigzag_decode(errs, eb)
    out, last = _grouped_prefix_finish(deltas, elem_sz, ndims,
                                       nb - 1, state)
    return out[: nb * BLOCK_SZ, :nd0], last[:nd0]

def _decode_lowdim_grouped_scatter(dense, widths, out_block_rows,
                                   elem_sz, total_rows, state=None):
    """Runs-stream lowdim delta decode without the (N, D) scatter.

    Zigzag-decoded row deltas pack into ONE int32 word per row
    (lowdim row_b = D*elem_sz <= 4 always) and scatter into a FLAT
    timeline addressed directly in grouped (ct, 8, G) coordinates:
    the scatter is 1-D on a full-minor array (not the legacy
    (N, D<=4) row scatter) and the scattered result needs NO transpose before
    the grouped prefix. Run blocks stay zero words = zero deltas =
    carry-forward, realizing RLE semantics for free.
    """
    from .ops.bitmath import sign_extend, zigzag_decode
    from .ops.pack import lowdim_group, unpack_dims_lowdim

    eb = 8 * elem_sz
    mask = (1 << eb) - 1
    nb, ndims, ebytes = dense.shape
    nd0 = ndims
    if ndims == 3 and LOWDIM_D3 != "native":
        # fold as d4 (see _decode_lowdim_grouped)
        dense = jnp.concatenate(
            [dense, jnp.zeros((nb, 1, ebytes), dense.dtype)], axis=1)
        widths = jnp.concatenate(
            [widths, jnp.zeros((nb, 1), widths.dtype)], axis=1)
        if state is not None:
            state = jnp.concatenate(
                [state, jnp.zeros((1,), state.dtype)])
        ndims = 4
    g = lowdim_group(ndims)
    pad = (-nb) % g
    if pad:
        dense = jnp.concatenate(
            [dense, jnp.zeros((pad, ndims, ebytes), dense.dtype)])
        widths = jnp.concatenate(
            [widths, jnp.zeros((pad, ndims), widths.dtype)])
        out_block_rows = jnp.concatenate(
            [out_block_rows.reshape(-1),
             jnp.full((pad,), total_rows,
                      out_block_rows.dtype)])  # dropped by mode="drop"
    c = (nb + pad) // g
    errs = unpack_dims_lowdim(
        dense.reshape(c, g * ndims, ebytes).astype(jnp.int32),
        widths.reshape(c, g * ndims).astype(jnp.int32))  # (c, 8, g*D)
    deltas_u = zigzag_decode(errs, eb) & mask
    if ndims == 1:
        packed = deltas_u  # (c, 8, g)
    else:
        packed = deltas_u[..., 0::ndims]
        for d in range(1, ndims):
            packed = packed | (deltas_u[..., d::ndims] << (eb * d))
    # timeline in grouped-flat coordinates
    nbt = total_rows // BLOCK_SZ
    ct = (nbt + (-nbt) % g) // g
    tb = (out_block_rows.reshape(-1) // BLOCK_SZ).astype(jnp.int32)
    tb_g = tb.reshape(c, g)
    idx_g = ((tb_g // g) * (BLOCK_SZ * g) + (tb_g % g))[:, None, :] \
        + jnp.arange(BLOCK_SZ, dtype=jnp.int32)[None, :, None] * g
    flat = jnp.zeros((ct * BLOCK_SZ * g,), jnp.int32)
    flat = flat.at[idx_g.reshape(-1)].set(packed.reshape(-1),
                                          mode="drop")
    ft = flat.reshape(ct, BLOCK_SZ, g)
    if ndims == 1:
        deltas2 = sign_extend(ft, eb)
    else:
        rep = jnp.repeat(ft[..., None], ndims, -1)
        rep = jax.lax.bitcast_convert_type(
            rep.reshape(ct, BLOCK_SZ, g * ndims), jnp.uint32)
        sh = jnp.tile(jnp.arange(ndims, dtype=jnp.uint32) * eb, g)
        deltas2 = sign_extend(
            ((rep >> sh) & jnp.uint32(mask)).astype(jnp.int32), eb)
    out, last = _grouped_prefix_finish(deltas2, elem_sz, ndims,
                                       nbt - 1, state)
    return out[:total_rows, :nd0], last[:nd0]


@dataclasses.dataclass
class StreamIndex:
    """Result of the host header walk: where everything lives."""

    widths: np.ndarray  # (ndata, D) uint8 per data block (max width 16)
    payload_offsets: np.ndarray  # (ndata,) int64 byte offset of block payload
    out_rows: np.ndarray  # (ndata,) int64 starting row of each data block
    total_rows: int
    tail_offset: int  # byte offset of the verbatim tail


def walk_headers(buf: bytes, ngroups: int, ndims: int, elem_sz: int,
                 start: int = METADATA_LEN_RLE, lowdim: bool = False,
                 padded: np.ndarray | None = None) -> StreamIndex:
    """Sequential walk over group headers to index payloads and runs.

    Uses the native C++ walker when available (native/sprintz_host.cpp);
    the Python loop below is the reference implementation and fallback.
    ``padded``: optional shared pad_stream(buf) — pass it when walking
    many segments of one buffer so each call skips the pad copy.
    """
    from .native_host import walk_headers_native

    native = walk_headers_native(bytes(buf), start, ngroups, ndims, elem_sz,
                                 lowdim, padded=padded)
    if native is not None:
        widths, offsets, out_rows, total_rows, tail_offset = native
        return StreamIndex(
            widths=widths, payload_offsets=offsets, out_rows=out_rows,
            total_rows=total_rows, tail_offset=tail_offset)
    return _walk_headers_py(buf, ngroups, ndims, elem_sz, start, lowdim)


def walk_headers_parallel(buf: bytes, ngroups: int, ndims: int,
                          elem_sz: int, byte_offsets: np.ndarray,
                          row_offsets: np.ndarray, every_groups: int,
                          lowdim: bool = False, max_workers: int = 16
                          ) -> StreamIndex:
    """Segment-parallel header walk using sidecar checkpoint offsets.

    The serial walk is O(groups) and single-threaded; with a sidecar
    (checkpoint.py) every ``every_groups``-group segment starts at a
    known byte/row offset, so segments walk concurrently (the native
    walker releases the GIL during its C loop). Output equals
    ``walk_headers``. This is the host-stage parallelization of the
    north-star decode plan (SURVEY §2.10).
    """
    from concurrent.futures import ThreadPoolExecutor

    from .native_host import pad_stream, walk_headers_parallel_native

    C = len(byte_offsets)
    if C <= 1 or ngroups <= every_groups:
        return walk_headers(buf, ngroups, ndims, elem_sz, lowdim=lowdim)
    native = walk_headers_parallel_native(
        bytes(buf), byte_offsets, row_offsets, every_groups, ngroups,
        ndims, elem_sz, lowdim)
    if native is not None:
        widths, offsets, out_rows, total_rows, tail_offset = native
        return StreamIndex(
            widths=widths, payload_offsets=offsets, out_rows=out_rows,
            total_rows=total_rows, tail_offset=tail_offset)
    padded = pad_stream(buf)  # shared: per-segment pad copies are O(C*N)

    # batch several checkpoint segments per task: native-call overhead
    # (array allocs, ctypes) dominates at every_groups=16-ish segments
    segs_per = max(1, C // (max_workers * 4))

    def one(j):
        k0 = j * segs_per
        g0 = k0 * every_groups
        g1 = min((k0 + segs_per) * every_groups, ngroups)
        return k0, walk_headers(buf, g1 - g0, ndims, elem_sz,
                                start=int(byte_offsets[k0]), lowdim=lowdim,
                                padded=padded)

    ntasks = -(-C // segs_per)
    with ThreadPoolExecutor(min(max_workers, ntasks)) as ex:
        parts = [p for _, p in sorted(ex.map(one, range(ntasks)))]
    row_offsets = row_offsets[::segs_per]
    for k, p in enumerate(parts[:-1]):
        if row_offsets[k] + p.total_rows != row_offsets[k + 1]:
            from .errors import CorruptStreamError

            raise CorruptStreamError(
                f"sidecar inconsistent with stream at checkpoint {k}: "
                f"segment rows {p.total_rows} != recorded row span")
    return StreamIndex(
        widths=np.concatenate([p.widths for p in parts]),
        payload_offsets=np.concatenate(
            [p.payload_offsets for p in parts]),
        out_rows=np.concatenate(
            [p.out_rows + int(row_offsets[k])
             for k, p in enumerate(parts)]),
        total_rows=int(row_offsets[-1]) + parts[-1].total_rows,
        tail_offset=parts[-1].tail_offset,
    )


def _walk_headers_py(buf: bytes, ngroups: int, ndims: int, elem_sz: int,
                     start: int = METADATA_LEN_RLE, lowdim: bool = False
                     ) -> StreamIndex:
    hdr_bits = nbits_sz_bits(elem_sz)
    elem_bits = 8 * elem_sz
    total_header_bits = ndims * hdr_bits * GROUP_SZ_BLOCKS
    total_header_bytes = (total_header_bits + 7) // 8

    widths_list = []
    offsets = []
    out_rows = []
    pos = start
    row = 0
    buf_len = len(buf)
    buf_np = np.frombuffer(buf, dtype=np.uint8)

    def _overrun(what: str):
        from .errors import CorruptStreamError

        raise CorruptStreamError(
            f"stream walk overran the buffer reading {what} at byte {pos} "
            f"(len {buf_len}): truncated stream or inconsistent metadata")

    for _g in range(ngroups):
        if pos + total_header_bytes > buf_len:
            _overrun("a group header")
        hdr = unpack_headers(
            buf_np[pos : pos + total_header_bytes][None, :], 1, ndims, hdr_bits)
        pos += total_header_bytes
        for b in range(GROUP_SZ_BLOCKS):
            w = hdr[b].astype(np.int64)
            w = np.where(w == elem_bits - 1, elem_bits, w)
            wsum = int(w.sum())
            if wsum == 0:
                if pos >= buf_len:
                    _overrun("a run varint")
                low = buf[pos]
                pos += 1
                length = low & 0x7F
                if low & 0x80:
                    if pos >= buf_len:
                        _overrun("a 2-byte run varint")
                    length |= buf[pos] << 7
                    pos += 1
                row += length * BLOCK_SZ
                continue
            widths_list.append(w)
            offsets.append(pos)
            out_rows.append(row)
            if lowdim:
                pos += wsum  # each dim: 8 * w bits == w bytes
            else:
                pos += BLOCK_SZ * ((wsum + 7) // 8)
            if pos > buf_len:
                _overrun("a block payload")
            row += BLOCK_SZ
    ndata = len(widths_list)
    return StreamIndex(
        widths=(np.stack(widths_list).astype(np.uint8)
                if ndata else np.zeros((0, ndims), np.uint8)),
        payload_offsets=np.asarray(offsets, dtype=np.int64),
        out_rows=np.asarray(out_rows, dtype=np.int64),
        total_rows=row,
        tail_offset=pos,
    )



@functools.partial(jax.jit, static_argnames=(
    "codec", "elem_sz", "lowdim", "total_rows"))
def _decode_pass(dense, widths, out_block_rows, codec, elem_sz, lowdim,
                 total_rows, init_state=None):
    """dense: (ndata, 8, MAXB) or (ndata, D, EB) int32 bytes.

    ``init_state``: optional (3, D) int32 forecaster state entering the
    stream slice (checkpoint.py): row 0 = prev value, rows 1-2 = FIRE
    prev delta / counter.
    """
    eb = 8 * elem_sz
    # The flat-scatter grouped runs path is explicit-opt-in only; "auto"
    # routes runs streams through the gather timeline below.
    if lowdim and LOWDIM_PASS == "grouped" and codec == "delta":
        vals, _ = _decode_lowdim_grouped_scatter(
            dense, widths, out_block_rows, elem_sz, total_rows,
            state=None if init_state is None else init_state[0])
        return vals
    # "auto" = plain block gather (see RUNS_TIMELINE).
    use_dgather = RUNS_TIMELINE == "dgather"
    if (use_dgather and total_rows % BLOCK_SZ == 0 and not lowdim):
        # Byte-gather timeline: place the PACKED payload blocks on
        # the timeline before unpacking (run slots keep width-0
        # rows, which unpack to the zero deltas runs need). The
        # gathered array is u8 payload (~1/8 the i32 errs the
        # block-gather variant moves twice); the unpack then writes
        # the timeline directly. Cost: the unpack weight tensor
        # grows from ndata to timeline blocks.
        nbt = total_rows // BLOCK_SZ
        nd0 = dense.shape[0]
        src = jnp.full((nbt,), nd0, jnp.int32)
        src = src.at[out_block_rows // BLOCK_SZ].set(
            jnp.arange(out_block_rows.shape[0], dtype=jnp.int32),
            mode="drop")
        dense_t = jnp.concatenate(
            [dense, jnp.zeros((1,) + dense.shape[1:], dense.dtype)]
        )[src].astype(jnp.int32)
        widths_t = jnp.concatenate(
            [widths, jnp.zeros((1, widths.shape[1]), widths.dtype)]
        )[src].astype(jnp.int32)
        errs = unpack_rows_rowmajor(
            dense_t, widths_t, pair=_pair_ok(elem_sz), elem_sz=elem_sz,
            chunk_blocks=8192 if codec == "xff" else None)
        full = errs.reshape(nbt * BLOCK_SZ, errs.shape[2])
        if codec == "delta":
            vals = delta_decode(full, eb)
            if init_state is not None:
                vals = (vals + init_state[0][None, :]) & ((1 << eb) - 1)
        else:
            vals = fire_decode(full, eb, truncate_coeffs=not lowdim,
                               init_state=init_state)
        return vals.astype(jnp.uint8 if elem_sz == 1 else jnp.uint16)
    dense = dense.astype(jnp.int32)  # transferred as u8, computed wide
    widths = widths.astype(jnp.int32)
    if lowdim:
        errs = _unpack_lowdim_best(dense, widths)
    else:
        errs = unpack_rows_rowmajor(
            dense, widths, pair=_pair_ok(elem_sz), elem_sz=elem_sz,
            chunk_blocks=8192 if codec == "xff" else None)
    ndata, _, ndims = errs.shape
    if (RUNS_TIMELINE in ("gather", "ngather", "auto", "dgather")
            and total_rows % BLOCK_SZ == 0):
        # Block-gather timeline: runs are whole blocks (the RLE unit,
        # golden/stream.py), so block starts are 8-aligned and the
        # (ndata*8, D) row scatter collapses to one tiny (ndata,)
        # index scatter plus a major-axis gather with full minor
        # tiles.
        nbt = total_rows // BLOCK_SZ
        src = jnp.full((nbt,), ndata, jnp.int32)
        src = src.at[out_block_rows // BLOCK_SZ].set(
            jnp.arange(out_block_rows.shape[0], dtype=jnp.int32),
            mode="drop")
        if RUNS_TIMELINE == "ngather":
            # narrow-gather: zigzag errs fit the
            # element width exactly, so gather 1 (u8) or 2 (u16)
            # bytes per value instead of the i32 — 4x/2x less gather
            # traffic; the widen fuses into the prefix input.
            ndt = jnp.uint8 if elem_sz == 1 else jnp.uint16
            errs_n = errs.astype(ndt)
            errs_pad = jnp.concatenate(
                [errs_n, jnp.zeros((1, BLOCK_SZ, ndims), ndt)])
            full = errs_pad[src].reshape(
                nbt * BLOCK_SZ, ndims).astype(jnp.int32)
        else:
            errs_pad = jnp.concatenate(
                [errs, jnp.zeros((1, BLOCK_SZ, ndims), errs.dtype)])
            full = errs_pad[src].reshape(nbt * BLOCK_SZ, ndims)
    else:
        full = jnp.zeros((total_rows, ndims), dtype=jnp.int32)
        row_idx = (out_block_rows[:, None]
                   + jnp.arange(BLOCK_SZ)[None, :]).reshape(-1)
        full = full.at[row_idx].set(
            errs.reshape(ndata * BLOCK_SZ, ndims), mode="drop")
    if codec == "delta":
        vals = delta_decode(full, eb)
        if init_state is not None:
            vals = (vals + init_state[0][None, :]) & ((1 << eb) - 1)
    else:
        vals = fire_decode(full, eb, truncate_coeffs=not lowdim,
                           init_state=init_state)
    # narrow on device: 4x less host transfer
    return vals.astype(jnp.uint8 if elem_sz == 1 else jnp.uint16)



def _fold_ok(codec, ndims, nb):
    g = 128 // ndims if ndims and 128 % ndims == 0 else 0
    return (ROWMAJOR_FOLD and codec == "delta" and 1 < g
            and nb % g == 0)

def _decode_rowmajor_folded(dense, widths, elem_sz):
    """Delta rowmajor decode with G = 128/D consecutive blocks folded
    into one 128-lane virtual block — the rowmajor analogue of the
    grouped lowdim pass. At D < 128 every bf16/i32 tensor with a
    D-minor pads its lane dim under a 128-lane tiling; folding makes the unpack
    output, zigzag, and prefix all full-lane. The per-chain prefix
    (lane (g, d) sums real blocks vG+g over v) is fixed up exactly:
    real block vG+g needs + sum_{g'<g} incl[g'][v] +
    sum_{g'>g} excl[g'][v], a G-length static cumsum over (nbf, G, D)
    block sums. Delta only — FIRE's recurrence is nonlinear so a
    post-add cannot splice chains.

    dense: (nb, 8, MAXB); widths: (nb, D). Returns (nb*8, D) narrow.
    """
    from .models.forecasters import hierarchical_cumsum
    from .ops.bitmath import zigzag_decode

    eb = 8 * elem_sz
    nb, _, maxb = dense.shape
    ndims = widths.shape[-1]
    g = 128 // ndims
    nbf = nb // g
    d32 = dense.astype(jnp.int32)
    w32 = widths.astype(jnp.int32)
    dense_f = d32.reshape(nbf, g, BLOCK_SZ, maxb).transpose(
        0, 2, 1, 3).reshape(nbf, BLOCK_SZ, g * maxb)
    widths_f = w32.reshape(nbf, g * ndims)
    off0 = jnp.cumsum(w32, axis=1) - w32  # (nb, D)
    off_f = (off0.reshape(nbf, g, ndims)
             + (jnp.arange(g) * 8 * maxb)[None, :, None]
             ).reshape(nbf, g * ndims)
    errs = unpack_rows_rowmajor(dense_f, widths_f, off=off_f,
                                elem_sz=elem_sz)
    deltas = zigzag_decode(errs, eb)  # (nbf, 8, 128)
    pref = hierarchical_cumsum(
        deltas.reshape(nbf * BLOCK_SZ, g * ndims), value_bits=eb
    ).reshape(nbf, BLOCK_SZ, g, ndims)
    incl = pref[:, -1]  # (nbf, G, D) chain-inclusive through block v
    excl = jnp.concatenate(
        [jnp.zeros_like(incl[:1]), incl[:-1]], axis=0)
    pre = jnp.cumsum(incl, axis=1) - incl  # sum_{g'<g} incl[g'][v]
    post = jnp.flip(
        jnp.cumsum(jnp.flip(excl, 1), axis=1) - jnp.flip(excl, 1), 1)
    vals = (pref + (pre + post)[:, None]) & ((1 << eb) - 1)
    out = vals.astype(jnp.uint8 if elem_sz == 1 else jnp.uint16)
    return out.transpose(0, 2, 1, 3).reshape(nb * BLOCK_SZ, ndims)

@functools.partial(jax.jit, static_argnames=(
    "codec", "elem_sz", "lowdim"))
def _decode_pass_contiguous(dense, widths, codec, elem_sz, lowdim):
    """Run-free fast path: block rows ARE the timeline, so the
    per-row scatter is replaced by a reshape. Selected when the host walk shows
    total_rows == ndata * 8."""
    eb = 8 * elem_sz
    if lowdim:
        lp = _lowdim_pass(codec, widths.shape[-1], elem_sz)
        if lp == "dmajor":
            vals, _ = _decode_lowdim_dmajor(dense, widths, elem_sz)
            return vals
        if lp == "grouped":
            vals, _ = _decode_lowdim_grouped(dense, widths, elem_sz)
            return vals
    if not lowdim and _fold_ok(codec, widths.shape[-1], dense.shape[0]):
        return _decode_rowmajor_folded(dense, widths, elem_sz)
    dense = dense.astype(jnp.int32)
    widths = widths.astype(jnp.int32)
    if lowdim:
        errs = _unpack_lowdim_best(dense, widths)
    else:
        errs = unpack_rows_rowmajor(
            dense, widths, pair=_pair_ok(elem_sz), elem_sz=elem_sz,
            chunk_blocks=8192 if codec == "xff" else None)
    ndata, _, ndims = errs.shape
    flat = errs.reshape(ndata * BLOCK_SZ, ndims)
    if codec == "delta":
        vals = delta_decode(flat, eb)
    else:
        vals = fire_decode(flat, eb, truncate_coeffs=not lowdim)
    return vals.astype(jnp.uint8 if elem_sz == 1 else jnp.uint16)



@functools.partial(jax.jit, static_argnames=(
    "codec", "elem_sz", "lowdim", "nb", "d1", "d2"))
def _decode_pass_contiguous_flat(dense_fl, widths_fl, codec, elem_sz,
                                 lowdim, nb, d1, d2):
    """Flat-param twin of _decode_pass_contiguous:
    identical math, but the jit parameters are 1-D so no padded
    minor-dim layout exists at rest; the reshapes fuse into the
    first consumers. dense is (nb, d1, d2) — (nb, 8, maxb) rowmajor
    or (nb, D, EB) lowdim."""
    return _decode_pass_contiguous.__wrapped__(
        dense_fl.reshape(nb, d1, d2),
        widths_fl.reshape(nb, -1), codec, elem_sz, lowdim)

@functools.partial(jax.jit, static_argnames=(
    "codec", "elem_sz", "lowdim", "nb", "d1", "d2"))
def _decode_pass_contiguous_chunk_flat(dense_fl, widths_fl, state,
                                       codec, elem_sz, lowdim, nb,
                                       d1, d2):
    """Flat-param twin of _decode_pass_contiguous_chunk."""
    return _decode_pass_contiguous_chunk.__wrapped__(
        dense_fl.reshape(nb, d1, d2),
        widths_fl.reshape(nb, -1), state, codec, elem_sz, lowdim)



@functools.partial(jax.jit, static_argnames=(
    "codec", "elem_sz", "lowdim", "total_rows", "nb", "d1", "d2"))
def _decode_pass_flat(dense_fl, widths_fl, out_block_rows, codec,
                      elem_sz, lowdim, total_rows, nb, d1, d2,
                      init_state=None):
    """Flat-param twin of _decode_pass (runs-capable timeline)."""
    return _decode_pass.__wrapped__(
        dense_fl.reshape(nb, d1, d2), widths_fl.reshape(nb, -1),
        out_block_rows, codec, elem_sz, lowdim, total_rows,
        init_state)


def _run_pass(dense: np.ndarray, widths: np.ndarray, out_rows_j,
              codec: str, elem_sz: int, lowdim: bool, nd_pad: int,
              rows_pad: int, init_state=None):
    """Dispatch one runs-capable decode pass with the production param
    layout (flat 1-D when _decode_flat_ok)."""
    d = pad_rows(dense, nd_pad)
    w = pad_rows(widths, nd_pad)
    if _decode_flat_ok(lowdim):
        return _decode_pass_flat(
            jnp.asarray(np.ascontiguousarray(d).reshape(-1)),
            jnp.asarray(np.ascontiguousarray(w).reshape(-1)),
            out_rows_j, codec, elem_sz, lowdim, rows_pad, nd_pad,
            d.shape[1], d.shape[2], init_state)
    return _decode_pass(jnp.asarray(d), jnp.asarray(w), out_rows_j,
                        codec, elem_sz, lowdim, rows_pad, init_state)


def _run_contiguous(dense: np.ndarray, widths: np.ndarray, codec: str,
                    elem_sz: int, lowdim: bool, nd_pad: int):
    """Dispatch one contiguous decode pass with the production param
    layout (flat 1-D params when _decode_flat_ok)."""
    d = pad_rows(dense, nd_pad)
    w = pad_rows(widths, nd_pad)
    if _decode_flat_ok(lowdim):
        return _decode_pass_contiguous_flat(
            jnp.asarray(np.ascontiguousarray(d).reshape(-1)),
            jnp.asarray(np.ascontiguousarray(w).reshape(-1)),
            codec, elem_sz, lowdim, nd_pad, d.shape[1], d.shape[2])
    return _decode_pass_contiguous(
        jnp.asarray(d), jnp.asarray(w), codec, elem_sz, lowdim)


def _run_contiguous_chunk(dense: np.ndarray, widths: np.ndarray, state,
                          codec: str, elem_sz: int, lowdim: bool,
                          chunk_nb: int):
    d = pad_rows(dense, chunk_nb)
    w = pad_rows(widths, chunk_nb)
    if _decode_flat_ok(lowdim):
        return _decode_pass_contiguous_chunk_flat(
            jnp.asarray(np.ascontiguousarray(d).reshape(-1)),
            jnp.asarray(np.ascontiguousarray(w).reshape(-1)),
            state, codec, elem_sz, lowdim, chunk_nb, d.shape[1],
            d.shape[2])
    return _decode_pass_contiguous_chunk(
        jnp.asarray(d), jnp.asarray(w), state, codec, elem_sz, lowdim)



@functools.partial(jax.jit, static_argnames=(
    "codec", "elem_sz", "lowdim"))
def _decode_pass_contiguous_chunk(dense, widths, state, codec, elem_sz,
                                  lowdim):
    """One tile of a chunked contiguous decode.

    ``state``: (3, D) int32 forecaster state entering the tile
    (delta uses row 0 = previous value; FIRE all three rows).
    Returns (narrow values, state leaving the tile). Keeping tiles
    bounded keeps the device working set on the fast side of the
    HBM working-set cliff for very long streams.
    """
    from .models.forecasters import fire_decode_chunk

    eb = 8 * elem_sz
    if lowdim:
        lp = _lowdim_pass(codec, widths.shape[-1], elem_sz)
        if lp == "dmajor":
            vals, last = _decode_lowdim_dmajor(dense, widths, elem_sz,
                                               state=state[0])
            return vals, state.at[0].set(last)
        if lp == "grouped":
            vals, last = _decode_lowdim_grouped(dense, widths, elem_sz,
                                                state=state[0])
            return vals, state.at[0].set(last)
    dense = dense.astype(jnp.int32)
    widths = widths.astype(jnp.int32)
    if lowdim:
        errs = _unpack_lowdim_best(dense, widths)
    else:
        errs = unpack_rows_rowmajor(
            dense, widths, pair=_pair_ok(elem_sz), elem_sz=elem_sz,
            chunk_blocks=8192 if codec == "xff" else None)
    ndata, _, ndims = errs.shape
    flat = errs.reshape(ndata * BLOCK_SZ, ndims)
    if codec == "delta":
        vals = delta_decode(flat, eb)
        vals = (vals + state[0][None, :]) & ((1 << eb) - 1)
        new_state = state.at[0].set(vals[-1])
    else:
        vals, new_state = fire_decode_chunk(
            flat, eb, truncate_coeffs=not lowdim,
            init_state=(state[0], state[1], state[2]))
    return vals.astype(
        jnp.uint8 if elem_sz == 1 else jnp.uint16), new_state



@functools.partial(jax.jit, static_argnames=(
    "codec", "elem_sz", "lowdim", "rows_pad", "contiguous"))
def _decode_pass_chunks(dense, widths, local_rows, states, codec,
                        elem_sz, lowdim, rows_pad, contiguous):
    """Sidecar chunk-parallel decode (checkpoint.decompress_parallel).

    The FIRE recurrence is serial over blocks (SURVEY §5), so a single
    stream decodes on D lanes only. With checkpoint states every chunk
    boundary the chunks become independent: vmap runs the scan C
    chunks wide (C*D lanes) and the serial length drops from nb to
    nb/C — the realization of ``jump()`` (online.hpp:126-132).

    dense: (C, nb, 8, MAXB) u8 payload bytes; widths: (C, nb, D);
    local_rows: (C, nb) block start rows within their chunk (>=
    rows_pad for padding blocks); states: (C, 3, D) forecaster state
    entering each chunk. Returns (C, rows_pad, D) narrow values.
    ``contiguous``: run-free stream — block rows are the chunk
    timeline, skip the scatter.
    """
    eb = 8 * elem_sz

    def one(dense_c, widths_c, rows_c, state_c):
        d = dense_c.astype(jnp.int32)
        w = widths_c.astype(jnp.int32)
        if lowdim:
            errs = _unpack_lowdim_best(d, w)
        else:
            errs = unpack_rows_rowmajor(
                d, w, pair=_pair_ok(elem_sz), elem_sz=elem_sz,
                chunk_blocks=8192 if codec == "xff" else None)
        nb, _, ndims = errs.shape
        if contiguous:
            full = errs.reshape(nb * BLOCK_SZ, ndims)[:rows_pad]
        elif RUNS_TIMELINE == "gather" and rows_pad % BLOCK_SZ == 0:
            # same block-gather timeline as _decode_pass: run starts
            # are 8-aligned, so whole blocks gather on the major axis
            nbt = rows_pad // BLOCK_SZ
            src = jnp.full((nbt,), nb, jnp.int32)
            src = src.at[rows_c // BLOCK_SZ].set(
                jnp.arange(nb, dtype=jnp.int32), mode="drop")
            errs_pad = jnp.concatenate(
                [errs, jnp.zeros((1, BLOCK_SZ, ndims), errs.dtype)])
            full = errs_pad[src].reshape(nbt * BLOCK_SZ, ndims)
        else:
            full = jnp.zeros((rows_pad, ndims), jnp.int32)
            ridx = (rows_c[:, None]
                    + jnp.arange(BLOCK_SZ)[None, :]).reshape(-1)
            full = full.at[ridx].set(
                errs.reshape(nb * BLOCK_SZ, ndims), mode="drop")
        if codec == "delta":
            vals = delta_decode(full, eb)
            vals = (vals + state_c[0][None, :]) & ((1 << eb) - 1)
        else:
            vals = fire_decode(
                full, eb, truncate_coeffs=not lowdim,
                init_state=(state_c[0], state_c[1], state_c[2]))
        return vals.astype(jnp.uint8 if elem_sz == 1 else jnp.uint16)

    return jax.vmap(one)(dense, widths, local_rows, states)

@functools.partial(jax.jit, static_argnames=(
    "codec", "elem_sz", "lowdim", "rows_pad", "contiguous",
    "C", "nb", "d1", "d2", "ndims"))
def _decode_pass_chunks_flat(dense_fl, widths_fl, local_rows, states,
                             codec, elem_sz, lowdim, rows_pad,
                             contiguous, C, nb, d1, d2, ndims):
    """Flat-param twin of _decode_pass_chunks: the
    (C, nb, 8, maxb) u8 and (C, nb, D) i32 params pad their minor
    dims at rest; 1-D params reshape inside jit."""
    return _decode_pass_chunks.__wrapped__(
        dense_fl.reshape(C, nb, d1, d2),
        widths_fl.reshape(C, nb, ndims), local_rows, states,
        codec, elem_sz, lowdim, rows_pad, contiguous)



@functools.partial(jax.jit, static_argnames=(
    "codec", "elem_sz", "lowdim", "total_rows"))
def _decode_pass_grouped(dense_g, widths_u, out_rows_g, codec, elem_sz,
                         lowdim, total_rows):
    """Width-signature-grouped decode (rowmajor only).

    Real streams repeat per-block width vectors, so the unpack weights
    are built once per UNIQUE signature and blocks sharing one reuse
    it inside a single batched matmul — the weight construction
    cost collapses from O(nb*D*MAXB) to O(U*D*MAXB).

    dense_g: (U, C, 8, MAXB) permuted payload bytes;
    widths_u: (U, D) unique signatures; out_rows_g: (U, C) block rows.
    """
    eb = 8 * elem_sz
    U, C, _, maxb = dense_g.shape
    ndims = widths_u.shape[1]
    dense_g = dense_g.astype(jnp.int32)
    widths_u = widths_u.astype(jnp.int32)
    off = jnp.cumsum(widths_u, axis=1) - widths_u  # (U, D)
    q = off >> 3
    j = jnp.arange(maxb)
    rel = j[None, None, :] - q[:, :, None]  # (U, D, MAXB)
    w = jnp.where(rel == 0, 1.0,
                  jnp.where(rel == 1, 256.0,
                            jnp.where(rel == 2, 65536.0, 0.0)))
    word = jax.lax.dot_general(
        dense_g.reshape(U, C * BLOCK_SZ, maxb).astype(jnp.bfloat16),
        w.transpose(0, 2, 1).astype(jnp.bfloat16),
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32).reshape(U, C, BLOCK_SZ, ndims)
    word = word >> (off & 7)[:, None, None, :]
    errs = word & ((1 << widths_u)[:, None, None, :] - 1)

    full = jnp.zeros((total_rows, ndims), dtype=jnp.int32)
    row_idx = (out_rows_g[:, :, None]
               + jnp.arange(BLOCK_SZ)[None, None, :]).reshape(-1)
    full = full.at[row_idx].set(
        errs.reshape(U * C * BLOCK_SZ, ndims), mode="drop")
    if codec == "delta":
        vals = delta_decode(full, eb)
    else:
        vals = fire_decode(full, eb, truncate_coeffs=not lowdim)
    return vals.astype(jnp.uint8 if elem_sz == 1 else jnp.uint16)



@functools.partial(jax.jit, static_argnames=(
    "codec", "elem_sz", "total_rows"))
def _decode_pass_ragged(dense_s, widths_s, widths_u, group_sizes,
                        out_rows_s, codec, elem_sz, total_rows):
    """Signature-sorted decode pass (rowmajor): ragged-dot unpack
    (one weight table for all blocks sharing a width signature, no
    per-block one-hot) + the block-gather timeline, which doubles as
    the inverse of the signature sort for free — out_rows_s carries
    the ORIGINAL block rows. Opt-in via SPRINTZ_RAGGED_DECODE until
    the device A/B."""
    from .ops.pack import unpack_rows_ragged

    eb = 8 * elem_sz
    errs = unpack_rows_ragged(
        dense_s.astype(jnp.int32), widths_s.astype(jnp.int32),
        widths_u.astype(jnp.int32), group_sizes)
    ndata, _, ndims = errs.shape
    nbt = total_rows // BLOCK_SZ
    src = jnp.full((nbt,), ndata, jnp.int32)
    src = src.at[out_rows_s // BLOCK_SZ].set(
        jnp.arange(ndata, dtype=jnp.int32), mode="drop")
    errs_pad = jnp.concatenate(
        [errs, jnp.zeros((1, BLOCK_SZ, ndims), errs.dtype)])
    full = errs_pad[src].reshape(nbt * BLOCK_SZ, ndims)
    if codec == "delta":
        vals = delta_decode(full, eb)
    else:
        vals = fire_decode(full, eb, truncate_coeffs=True)
    return vals.astype(jnp.uint8 if elem_sz == 1 else jnp.uint16)


def ragged_order(widths: np.ndarray):
    """Host prep for the ragged-dot unpack: lexicographic sort of blocks
    by width signature. Returns (order (ndata,), widths_u (U_pad, D),
    group_sizes (U_pad,) block counts, U) with U_pad pow2-bucketed —
    only the tiny per-UNIQUE tables pad, never the block lists."""
    ndata = widths.shape[0]
    order = np.lexsort(widths.T[::-1])
    sorted_w = widths[order]
    change = np.any(np.diff(sorted_w.astype(np.int16), axis=0) != 0,
                    axis=1) if ndata > 1 else np.zeros(0, bool)
    seg_starts = np.concatenate([[0], np.nonzero(change)[0] + 1])
    counts = np.diff(np.concatenate([seg_starts, [ndata]]))
    U = len(seg_starts)
    u_pad = next_bucket(U + 1)  # always a spare group for padding blocks
    widths_u = np.zeros((u_pad, widths.shape[1]), np.int32)
    widths_u[:U] = sorted_w[seg_starts]
    gs = np.zeros(u_pad, np.int32)
    gs[:U] = counts
    return order, widths_u, gs, U


def _use_ragged() -> bool:
    return config.flag("SPRINTZ_RAGGED_DECODE")


def group_by_signature(idx: StreamIndex, max_blowup: float = 3.0):
    """Host-side width-signature grouping for _decode_pass_grouped.

    Returns (uniq_widths (U_pad, D), block_perm (U_pad, C_pad) int64 index
    into data blocks with -1 padding) or None when grouping would blow up
    memory (near-unique signatures)."""
    ndata = idx.widths.shape[0]
    if ndata == 0:
        return None
    uniq, inv = np.unique(idx.widths, axis=0, return_inverse=True)
    U = uniq.shape[0]
    counts = np.bincount(inv, minlength=U)
    c_pad = next_bucket(int(counts.max()))
    u_pad = next_bucket(U)
    if u_pad * c_pad > max_blowup * max(ndata, 1) + 4096:
        return None
    perm = np.full((u_pad, c_pad), -1, dtype=np.int64)
    order = np.argsort(inv, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    for u in range(U):
        seg = order[starts[u] : starts[u + 1]]
        perm[u, : len(seg)] = seg
    uniq_pad = np.zeros((u_pad, uniq.shape[1]), dtype=np.int32)
    uniq_pad[:U] = uniq
    return uniq_pad, perm


def gather_payloads(buf: bytes, idx: StreamIndex, ndims: int, elem_sz: int,
                    lowdim: bool, pad_to: int | None = None) -> np.ndarray:
    """Gather packed payload bytes into a dense per-block buffer
    (vectorized index arithmetic, no per-block loops).

    ``pad_to``: allocate that many leading rows up front (tail zeroed)
    so the downstream ``pad_rows`` + flat-param ``ascontiguousarray``
    no-op instead of copying the whole dense buffer again."""
    from .native_host import gather_blocks_native, gather_dims_native

    buf_np = np.frombuffer(buf, dtype=np.uint8)
    ndata = idx.widths.shape[0]
    nd_alloc = max(pad_to or ndata, ndata)

    def alloc(shape_tail):
        full = np.empty((nd_alloc,) + shape_tail, dtype=np.uint8)
        if nd_alloc > ndata:
            full[ndata:] = 0
        return full

    if lowdim:
        maxb = 8 * elem_sz
        # native fills every byte (copy + pad memset) -> skip the
        # np.zeros memset, a full extra pass over the output buffer
        full_buf = alloc((ndims, maxb))
        dense = full_buf[:ndata]
        if ndata == 0:
            return full_buf
        if gather_dims_native(buf, idx.payload_offsets, idx.widths, dense):
            return full_buf
        dense[:] = 0  # numpy fallback scatters only payload bytes
        w = idx.widths.astype(np.int64)  # (ndata, D)
        unit_len = w.reshape(-1)
        unit_src = (np.repeat(idx.payload_offsets, ndims)
                    + (np.cumsum(w, axis=1) - w).reshape(-1))
        unit_dst = np.arange(ndata * ndims, dtype=np.int64) * maxb
    else:
        # size the buffer by the stream's actual max row width (bucketed):
        # compressible data has small rows, and the unpack weight tensor
        # scales with this byte count
        maxb = ndims * elem_sz
        if ndata:
            rb_max = int((idx.widths.sum(axis=1).max() + 7) // 8)
            if MAXB_BUCKET == "mult8":
                bucket = max((rb_max + 7) // 8 * 8, 8)
            else:
                # maxb is a MINOR dim in the unpack weights: pow2 only
                bucket = next_bucket(max(rb_max, 1), minimum=8, pow2=True)
            maxb = min(maxb, bucket)
        full_buf = alloc((BLOCK_SZ, maxb))
        dense = full_buf[:ndata]
        if ndata == 0:
            return full_buf
        rb = ((idx.widths.sum(axis=1) + 7) // 8).astype(np.int64)
        if gather_blocks_native(buf, idx.payload_offsets, rb, dense):
            return full_buf
        dense[:] = 0  # numpy fallback scatters only payload bytes
        unit_len = np.repeat(rb, BLOCK_SZ)
        unit_src = (np.repeat(idx.payload_offsets, BLOCK_SZ)
                    + np.tile(np.arange(BLOCK_SZ), ndata) * unit_len)
        unit_dst = np.arange(ndata * BLOCK_SZ, dtype=np.int64) * maxb
    nz = unit_len > 0
    unit_len, unit_src, unit_dst = unit_len[nz], unit_src[nz], unit_dst[nz]
    tot = int(unit_len.sum())
    if tot:
        from .native_host import gather_units_native

        if not gather_units_native(buf, unit_src, unit_dst, unit_len,
                                   dense):
            starts = np.cumsum(unit_len) - unit_len
            q = np.arange(tot) - np.repeat(starts, unit_len)
            flat = dense.reshape(-1)
            flat[np.repeat(unit_dst, unit_len) + q] = buf_np[
                np.repeat(unit_src, unit_len) + q]
    return full_buf


def index_and_gather(buf: bytes, ngroups: int, ndims: int, elem_sz: int,
                     lowdim: bool, pad_dense: bool = False
                     ) -> tuple[StreamIndex, np.ndarray]:
    """Walk + gather with the fused overlapped native pass when
    available (rowmajor): the walker thread indexes blocks while worker
    threads copy payload rows cache-hot — wall ~ max(walk, gather).
    Output is identical to walk_headers + gather_payloads.

    ``pad_dense``: return dense with ``next_bucket(ndata)`` leading rows
    (tail zeroed) so pad_rows + the flat-param ascontiguousarray no-op
    — removes a full copy of the multi-MB dense buffer from the host
    pipeline. ``idx`` itself is unchanged (its arrays stay ndata-long).
    """
    from .native_host import walk_gather_native

    if not lowdim and MAXB_BUCKET != "mult8":
        # dense row stride guess from a sampled prefix; the fused call
        # returns -3 if a later block exceeds it and we re-bucket.
        # Doubling from the sampled pow2 bucket converges on exactly the
        # bucket gather_payloads computes from the global max.
        maxb_logical = ndims * elem_sz
        sample = walk_headers(buf, min(int(ngroups), 64), ndims, elem_sz,
                              lowdim=False)
        if sample.widths.shape[0]:
            rb_s = int((sample.widths.sum(axis=1).max() + 7) // 8)
        else:
            rb_s = 1
        maxb = min(maxb_logical, next_bucket(max(rb_s, 1), minimum=8,
                                             pow2=True))
        while True:
            res = walk_gather_native(buf, METADATA_LEN_RLE, ngroups,
                                     ndims, elem_sz, maxb,
                                     pad_to_bucket=pad_dense)
            if res == -3 and maxb < maxb_logical:
                maxb = min(maxb_logical, maxb * 2)
                continue
            break
        if res is not None and res != -3:
            widths, offsets, out_rows, total_rows, tail_offset, dense = res
            idx = StreamIndex(widths=widths, payload_offsets=offsets,
                              out_rows=out_rows, total_rows=total_rows,
                              tail_offset=tail_offset)
            if pad_dense and widths.shape[0]:
                want = next_bucket(widths.shape[0])
                if dense.shape[0] != want:  # walk buffer too small: copy
                    dense = pad_rows(dense[: widths.shape[0]], want)
            return idx, dense
    idx = walk_headers(buf, ngroups, ndims, elem_sz, lowdim=lowdim)
    pad_to = (next_bucket(idx.widths.shape[0])
              if pad_dense and idx.widths.shape[0] else None)
    return idx, gather_payloads(buf, idx, ndims, elem_sz, lowdim,
                                pad_to=pad_to)


def decode_indexed(buf: bytes, idx: StreamIndex, ndims: int, elem_sz: int,
                   codec: str, init_state: np.ndarray | None = None,
                   lowdim: bool = False) -> np.ndarray:
    """Decode the rows covered by a StreamIndex (possibly a mid-stream
    slice) with an optional initial forecaster state. Returns (rows, D)."""
    import jax.numpy as jnp

    ndata = idx.widths.shape[0]
    nd_pad = next_bucket(max(ndata, 1))
    dense = gather_payloads(buf, idx, ndims, elem_sz, lowdim,
                            pad_to=nd_pad)
    if idx.total_rows == 0:
        return np.zeros((0, ndims), np.uint8 if elem_sz == 1 else np.uint16)
    rows_pad = next_bucket(idx.total_rows)
    out_rows_p = np.full(nd_pad, rows_pad + BLOCK_SZ, dtype=np.int64)
    out_rows_p[:ndata] = idx.out_rows  # walk starts its row count at 0
    state = (jnp.zeros((3, ndims), jnp.int32) if init_state is None
             else jnp.asarray(
                 np.vstack([init_state,
                            np.zeros((3 - init_state.shape[0], ndims))]
                           ).astype(np.int32)))
    vals = _run_pass(
        dense, idx.widths, jnp.asarray(out_rows_p, jnp.int32),
        codec, elem_sz, lowdim, nd_pad, rows_pad, state)
    udt = np.uint8 if elem_sz == 1 else np.uint16
    return np.asarray(vals[: idx.total_rows]).astype(udt)


def decompress_batch(
    bufs: list[bytes],
    codec: str = "delta",
    elem_sz: int = 1,
) -> list[np.ndarray]:
    """Decode S streams in one device pass (counterpart of
    encoder.compress_batch).

    All streams must share ndims; the per-stream walks run on host
    (native), payloads are padded to a common block count, and the
    contiguous decode pass is vmapped over the batch — FIRE's scan then
    runs S*D lanes wide, the throughput axis for many small streams
    (SURVEY §5). Streams containing RLE runs fall back to per-stream
    decode (correct, just not batched).
    """
    if not bufs:
        return []
    metas = [read_metadata_rle(b) for b in bufs]
    ndims = metas[0][2]
    simple = [i for i, (ng, rem, nd) in enumerate(metas)
              if ng == 0 and rem < MIN_DATA_SIZE]
    udt = np.uint8 if elem_sz == 1 else np.uint16
    out: list[np.ndarray | None] = [None] * len(bufs)
    for i in simple:
        out[i] = np.frombuffer(bufs[i], dtype=udt, count=metas[i][1],
                               offset=METADATA_LEN_RLE).copy()
    todo = [i for i in range(len(bufs)) if out[i] is None]
    if not todo:
        return out
    lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    idxs = {i: walk_headers(bufs[i], metas[i][0], ndims, elem_sz,
                            lowdim=lowdim) for i in todo}
    batchable = [i for i in todo
                 if metas[i][2] == ndims
                 and idxs[i].total_rows == idxs[i].widths.shape[0] * BLOCK_SZ
                 and idxs[i].total_rows > 0]
    # streams WITH runs batch too, through the vmapped block-gather
    # timeline — only degenerate/foreign streams
    # fall back to per-stream decode
    runs_batch = [i for i in todo
                  if i not in batchable and metas[i][2] == ndims
                  and idxs[i].total_rows > 0
                  and idxs[i].widths.shape[0] > 0]
    for i in todo:
        if i not in batchable and i not in runs_batch:
            out[i] = decompress(bufs[i], codec, elem_sz)
    if runs_batch:
        denses = {i: gather_payloads(bufs[i], idxs[i], ndims, elem_sz,
                                     lowdim) for i in runs_batch}
        nd_pad = next_bucket(max(idxs[i].widths.shape[0]
                                 for i in runs_batch))
        rows_pad = next_bucket(max(idxs[i].total_rows for i in runs_batch))
        maxb = max(denses[i].shape[2] for i in runs_batch)
        S = len(runs_batch)
        dense_b = np.zeros(
            (S, nd_pad, denses[runs_batch[0]].shape[1], maxb), np.uint8)
        widths_b = np.zeros((S, nd_pad, ndims), np.int32)
        rows_b = np.full((S, nd_pad), rows_pad + BLOCK_SZ, np.int64)
        for s, i in enumerate(runs_batch):
            d = denses[i]
            dense_b[s, : d.shape[0], :, : d.shape[2]] = d
            widths_b[s, : d.shape[0]] = idxs[i].widths
            rows_b[s, : d.shape[0]] = idxs[i].out_rows
        vals = _decode_pass_batch(
            jnp.asarray(dense_b), jnp.asarray(widths_b),
            jnp.asarray(rows_b, jnp.int32), codec, elem_sz, lowdim,
            rows_pad)
        vals = np.asarray(vals)
        for s, i in enumerate(runs_batch):
            body = vals[s, : idxs[i].total_rows].astype(udt).reshape(-1)
            tail = np.frombuffer(bufs[i], dtype=udt, count=metas[i][1],
                                 offset=idxs[i].tail_offset)
            out[i] = np.concatenate([body, tail])
    if batchable:
        denses = {i: gather_payloads(bufs[i], idxs[i], ndims, elem_sz,
                                     lowdim) for i in batchable}
        nd_pad = next_bucket(max(idxs[i].widths.shape[0]
                                 for i in batchable))
        maxb = max(denses[i].shape[2] for i in batchable)
        S = len(batchable)
        dense_b = np.zeros(
            (S, nd_pad, denses[batchable[0]].shape[1], maxb), np.uint8)
        widths_b = np.zeros((S, nd_pad, ndims), np.int32)
        for s, i in enumerate(batchable):
            d = denses[i]
            dense_b[s, : d.shape[0], :, : d.shape[2]] = d
            widths_b[s, : d.shape[0]] = idxs[i].widths
        vals = _decode_pass_contiguous_batch(
            jnp.asarray(dense_b), jnp.asarray(widths_b), codec, elem_sz,
            lowdim)
        vals = np.asarray(vals)
        for s, i in enumerate(batchable):
            body = vals[s, : idxs[i].total_rows].astype(udt).reshape(-1)
            tail = np.frombuffer(bufs[i], dtype=udt, count=metas[i][1],
                                 offset=idxs[i].tail_offset)
            out[i] = np.concatenate([body, tail])
    return out



@functools.partial(jax.jit, static_argnames=(
    "codec", "elem_sz", "lowdim"))
def _decode_pass_contiguous_batch(dense, widths, codec, elem_sz,
                                  lowdim):
    f = functools.partial(
        _decode_pass_contiguous.__wrapped__, codec=codec,
        elem_sz=elem_sz, lowdim=lowdim)
    return jax.vmap(f)(dense, widths)

@functools.partial(jax.jit, static_argnames=(
    "codec", "elem_sz", "lowdim", "rows_pad"))
def _decode_pass_batch(dense, widths, out_rows, codec, elem_sz,
                       lowdim, rows_pad):
    """vmapped general (runs-capable) decode pass: S streams decode
    in one dispatch, each through the block-gather timeline."""
    f = functools.partial(
        _decode_pass.__wrapped__, codec=codec, elem_sz=elem_sz,
        lowdim=lowdim, total_rows=rows_pad)
    return jax.vmap(f)(dense, widths, out_rows)


def decompress(
    buf: bytes,
    codec: str = "delta",
    elem_sz: int = 1,
    force_layout: str | None = None,
) -> np.ndarray:
    """Decompress a stream; returns the flat elements."""
    udt = np.uint8 if elem_sz == 1 else np.uint16
    if len(buf) < METADATA_LEN_RLE:
        from .errors import CorruptStreamError

        raise CorruptStreamError(
            f"stream shorter than its {METADATA_LEN_RLE}-byte metadata "
            f"({len(buf)} bytes)")
    ngroups, remaining_len, ndims = read_metadata_rle(buf)
    if ngroups == 0 and remaining_len < MIN_DATA_SIZE:
        return np.frombuffer(
            buf, dtype=udt, count=remaining_len, offset=METADATA_LEN_RLE).copy()

    if force_layout is None:
        lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    else:
        lowdim = force_layout == "lowdim"

    idx, dense = index_and_gather(buf, ngroups, ndims, elem_sz, lowdim,
                                  pad_dense=True)
    if idx.tail_offset + remaining_len * elem_sz > len(buf):
        from .errors import CorruptStreamError

        raise CorruptStreamError(
            f"verbatim tail truncated: need "
            f"{idx.tail_offset + remaining_len * elem_sz} bytes, "
            f"have {len(buf)}")
    ndata = idx.widths.shape[0]

    if (_use_ragged() and not lowdim and ndata
            and idx.total_rows % BLOCK_SZ == 0):
        order, widths_u, gs, U = ragged_order(idx.widths)
        nd_pad = next_bucket(ndata)
        rows_pad = next_bucket(idx.total_rows)
        gs[U] += nd_pad - ndata  # padding blocks -> the spare zero group
        dense_s = np.zeros((nd_pad,) + dense.shape[1:], dense.dtype)
        dense_s[:ndata] = dense[order]
        widths_s = np.zeros((nd_pad, ndims), np.int32)
        widths_s[:ndata] = idx.widths[order]
        out_rows_s = np.full(nd_pad, rows_pad + BLOCK_SZ, np.int64)
        out_rows_s[:ndata] = idx.out_rows[order]
        vals = _decode_pass_ragged(
            jnp.asarray(dense_s), jnp.asarray(widths_s),
            jnp.asarray(widths_u), jnp.asarray(gs),
            jnp.asarray(out_rows_s, jnp.int32), codec, elem_sz, rows_pad)
        body = np.asarray(vals[: idx.total_rows]).astype(udt).reshape(-1)
        tail = np.frombuffer(
            buf, dtype=udt, count=remaining_len, offset=idx.tail_offset)
        return np.concatenate([body, tail])

    if idx.total_rows:
        if idx.total_rows == ndata * BLOCK_SZ:
            # no runs anywhere -> blocks are the timeline (fast path)
            block_bytes = BLOCK_SZ * ndims * elem_sz
            chunk_nb = max(1, CHUNK_OUT_BYTES // block_bytes)
            if ndata > chunk_nb:
                # tile long streams; forecaster state carries across
                # tiles (the last tile's shape padding is harmless:
                # nothing consumes its exit state). Software-pipelined
                # depth 2: tile i+1's H2D + dispatch are issued (JAX
                # dispatch is async) BEFORE tile i's result is fetched,
                # so transfers overlap the previous tile's compute

                chunk_nb = next_bucket(chunk_nb)
                state = jnp.zeros((3, ndims), jnp.int32)
                parts = []
                prev = None  # (device vals, rows)
                for lo in range(0, ndata, chunk_nb):
                    hi = min(lo + chunk_nb, ndata)
                    vals, state = _run_contiguous_chunk(
                        dense[lo:hi], idx.widths[lo:hi], state, codec,
                        elem_sz, lowdim, chunk_nb)
                    if prev is not None:
                        parts.append(
                            np.asarray(prev[0][: prev[1]]).astype(udt))
                    prev = (vals, (hi - lo) * BLOCK_SZ)
                parts.append(np.asarray(prev[0][: prev[1]]).astype(udt))
                body = np.concatenate(parts).reshape(-1)
            else:
                nd_pad = next_bucket(ndata)
                vals = _run_contiguous(
                    dense, idx.widths, codec, elem_sz, lowdim, nd_pad)
                body = np.asarray(
                    vals[: idx.total_rows]).astype(udt).reshape(-1)
            tail = np.frombuffer(
                buf, dtype=udt, count=remaining_len, offset=idx.tail_offset)
            return np.concatenate([body, tail])
        rows_pad = next_bucket(idx.total_rows)
        # Width-signature grouping pads each signature's block list to
        # a power-of-two count, which can inflate device work beyond the
        # shared-weight savings. Opt-in for re-evaluation.
        use_grouped = config.flag("SPRINTZ_GROUPED_DECODE")
        grouping = (group_by_signature(idx)
                    if use_grouped and not lowdim else None)
        if grouping is not None:
            uniq_pad, perm = grouping
            u_pad, c_pad = perm.shape
            dense_g = np.zeros((u_pad, c_pad) + dense.shape[1:],
                               dtype=dense.dtype)
            out_rows_g = np.full((u_pad, c_pad), rows_pad + BLOCK_SZ,
                                 dtype=np.int64)
            valid = perm >= 0
            dense_g[valid] = dense[perm[valid]]
            out_rows_g[valid] = idx.out_rows[perm[valid]]
            vals = _decode_pass_grouped(
                jnp.asarray(dense_g), jnp.asarray(uniq_pad),
                jnp.asarray(out_rows_g, jnp.int32),
                codec, elem_sz, lowdim, rows_pad)
        else:
            # bucket shapes so the pass compiles per bucket, not per stream
            nd_pad = next_bucket(ndata)
            # padded blocks scatter out of range -> dropped by XLA
            out_rows_p = np.full(nd_pad, rows_pad + BLOCK_SZ, dtype=np.int64)
            out_rows_p[:ndata] = idx.out_rows
            vals = _run_pass(
                dense, idx.widths, jnp.asarray(out_rows_p, jnp.int32),
                codec, elem_sz, lowdim, nd_pad, rows_pad)
        body = np.asarray(vals[: idx.total_rows]).astype(udt).reshape(-1)
    else:
        body = np.empty(0, dtype=udt)

    tail = np.frombuffer(
        buf, dtype=udt, count=remaining_len, offset=idx.tail_offset)
    return np.concatenate([body, tail])
