"""Query pushdown: run max/sum reductions over a compressed stream.

API parity with the reference's ``QueryParams{op, materialize}``
(query.hpp:22-29) and ``query_rowmajor_{delta,xff}_rle_{8,16}b``
(sprintz_delta_rle_query.cpp:149-192).

Design: instead of cloning the decoder with a functor inlined
into its scalar loop (sprintz_delta_rle_query.hpp:33-430), decode and
reduce run as ONE jitted device program — the reduction consumes the
reconstructed rows before they would leave the chip, and with
``materialize=False`` only the (D,) result transfers to the host.

The reference's O(1)-per-run ``nrepeats`` trick (query.hpp:95-135) is
realized for delta + materialize=False by a COMPACT pass that never
materializes run rows at all: a delta run holds one constant value (the
last preceding data row, or 0 at stream start), so each run contributes
``run_rows * v_before`` to the sum in closed form, and only a possible 0
(leading run) to max/min. Work is O(data blocks), not O(rows); results
match the fused pass bit-for-bit (i32 sums wrap identically mod 2^32).
XFF runs extrapolate per-row (sprintz_xff_rle.cpp:836-942), so xff
queries keep the fused decode+reduce pass — the same split the
reference makes.
"""

from __future__ import annotations

import dataclasses
import enum
import functools

import numpy as np

from ..constants import BLOCK_SZ, LOWDIM_MAX_NDIMS, METADATA_LEN_RLE, MIN_DATA_SIZE
from ..golden.stream import read_metadata_rle


class Operation(enum.Enum):
    NOOP = 0
    REDUCE_MAX = 1
    REDUCE_SUM = 2
    REDUCE_MIN = 3  # extension: not in the reference enum


@dataclasses.dataclass(frozen=True)
class QueryParams:
    op: Operation = Operation.NOOP
    materialize: bool = True


@dataclasses.dataclass
class QueryResult:
    data: np.ndarray | None  # (rows, D) when materialized
    max: np.ndarray | None = None  # (D,)
    sum: np.ndarray | None = None  # (D,) int64
    min: np.ndarray | None = None  # (D,)


@functools.lru_cache(maxsize=None)
def _get_fused_run():
    """Module-cached jitted fused pass (a per-call jit would retrace on
    every query — the function object is the jit cache key)."""
    import jax
    import jax.numpy as jnp

    from .. import decoder as _dec

    @functools.partial(jax.jit, static_argnames=(
        "codec", "elem_sz", "lowdim", "total_rows", "op_id", "materialize"))
    def run(dense, widths, out_rows, n_valid, codec, elem_sz, lowdim,
            total_rows, op_id, materialize):
        vals = _dec._decode_pass.__wrapped__(
            dense, widths, out_rows, codec, elem_sz, lowdim, total_rows)
        v32 = vals.astype(jnp.int32)
        # rows past n_valid are shape padding holding repeated /
        # extrapolated values; they must not contribute
        valid = (jnp.arange(v32.shape[0]) < n_valid)[:, None]
        if op_id == Operation.REDUCE_MAX.value:
            red = jnp.max(jnp.where(valid, v32, 0), axis=0)
        elif op_id == Operation.REDUCE_MIN.value:
            red = jnp.min(jnp.where(valid, v32, 1 << 30), axis=0)
        elif op_id == Operation.REDUCE_SUM.value:
            # i32 accumulators, matching the reference's widening
            # (query.hpp:283-291); widened to i64 host-side
            red = jnp.sum(jnp.where(valid, v32, 0), axis=0, dtype=jnp.int32)
        else:
            red = jnp.zeros(v32.shape[1], jnp.int32)
        return red, (vals if materialize else red)

    return run


def _fused_pass(dense, widths, out_rows, n_valid, codec, elem_sz, lowdim,
                total_rows, op_id, materialize):
    """Decode + (masked) reduce in one device program."""
    return _get_fused_run()(
        dense, widths, out_rows, n_valid, codec, elem_sz, lowdim,
        total_rows, op_id, materialize)


# diagnostic: which device path the last query() call took
# ("compact" | "fused" | "verbatim")
last_path: str | None = None


@functools.lru_cache(maxsize=None)
def _get_compact_run():
    """Module-cached jitted compact pass (see _get_fused_run)."""
    import jax
    import jax.numpy as jnp

    from ..models.forecasters import hierarchical_cumsum
    from ..ops.bitmath import zigzag_decode
    from ..ops.pack import unpack_dims_lowdim, unpack_rows_rowmajor

    @functools.partial(jax.jit, static_argnames=("elem_sz", "lowdim", "op_id"))
    def run(dense, widths, gaps_before, trailing_gap, n_blocks, elem_sz,
            lowdim, op_id):
        eb = 8 * elem_sz
        dense = dense.astype(jnp.int32)
        widths = widths.astype(jnp.int32)
        errs = (unpack_dims_lowdim(dense, widths) if lowdim
                else unpack_rows_rowmajor(
                    dense, widths, elem_sz=elem_sz))  # (nb_pad, 8, D)
        nb_pad, _, ndims = errs.shape
        deltas = zigzag_decode(errs, eb).reshape(nb_pad * BLOCK_SZ, ndims)
        # runs carry zero delta, so the cumsum over compacted data rows
        # equals the timeline cumsum sampled at data rows
        vals = hierarchical_cumsum(deltas, value_bits=eb) & ((1 << eb) - 1)
        vals = vals.reshape(nb_pad, BLOCK_SZ, ndims)
        valid = (jnp.arange(nb_pad) < n_blocks)[:, None, None]
        # value entering each data block = last row of the previous one
        block_last = vals[:, -1, :]
        v_before = jnp.concatenate(
            [jnp.zeros_like(block_last[:1]), block_last[:-1]], axis=0)
        # value after the final data block (for the trailing run)
        v_last = jax.lax.dynamic_slice_in_dim(
            block_last, jnp.maximum(n_blocks - 1, 0), 1, axis=0)[0]
        if op_id == Operation.REDUCE_SUM.value:
            data_sum = jnp.sum(jnp.where(valid, vals, 0), axis=(0, 1),
                               dtype=jnp.int32)
            run_sum = jnp.sum(
                jnp.where(valid[:, 0], gaps_before[:, None] * v_before, 0),
                axis=0, dtype=jnp.int32)
            return data_sum + run_sum + trailing_gap * v_last
        leading_zero = gaps_before[0] > 0
        if op_id == Operation.REDUCE_MAX.value:
            m = jnp.max(jnp.where(valid, vals, 0), axis=(0, 1))
            # non-leading runs repeat data values already reduced;
            # a leading run contributes rows of zeros
            return jnp.where(leading_zero, jnp.maximum(m, 0), m)
        m = jnp.min(jnp.where(valid, vals, 1 << 30), axis=(0, 1))
        return jnp.where(leading_zero, jnp.minimum(m, 0), m)

    return run


@functools.lru_cache(maxsize=None)
def _get_compact_run_flat():
    """Flat-param twin: 1-D dense/widths jit params
    avoid the padded-at-rest minor-dim layouts."""
    import jax

    inner = _get_compact_run()

    @functools.partial(jax.jit, static_argnames=(
        "nb", "d1", "d2", "ndims", "elem_sz", "lowdim", "op_id"))
    def run(dense_fl, widths_fl, gaps_before, trailing_gap, n_blocks,
            nb, d1, d2, ndims, elem_sz, lowdim, op_id):
        return inner(dense_fl.reshape(nb, d1, d2),
                     widths_fl.reshape(nb, ndims), gaps_before,
                     trailing_gap, n_blocks, elem_sz, lowdim, op_id)

    return run


def _compact_delta_pass(dense, widths, gaps_before, trailing_gap, n_blocks,
                        elem_sz, lowdim, op_id):
    """O(data-blocks) delta reduction: run rows never materialize.

    dense/widths: padded numpy data-block payloads (nb_pad, ...);
    gaps_before: (nb_pad,) int32 run rows immediately before each data
    block; trailing_gap: scalar run rows after the last data block;
    n_blocks: number of valid data blocks. Returns the (D,) i32
    reduction. Params ship flat (1-D) per the decoder's flat layout
    findings.
    """
    import jax.numpy as jnp

    nb, d1, d2 = dense.shape
    ndims = widths.shape[1]
    return _get_compact_run_flat()(
        jnp.asarray(np.ascontiguousarray(dense).reshape(-1)),
        jnp.asarray(np.ascontiguousarray(widths).reshape(-1)),
        gaps_before, trailing_gap, n_blocks, nb, d1, d2, ndims,
        elem_sz, lowdim, op_id)


def query(
    buf: bytes,
    params: QueryParams,
    codec: str = "delta",
    elem_sz: int = 1,
) -> QueryResult:
    """Evaluate a query over a compressed stream; the decompressed data
    never reaches the host unless materialize=True."""
    import jax.numpy as jnp

    from .. import decoder as _dec
    from ..utils.shapes import next_bucket, pad_rows

    global last_path
    udt = np.uint8 if elem_sz == 1 else np.uint16
    ngroups, remaining_len, ndims = read_metadata_rle(buf)

    if ngroups == 0 and remaining_len < MIN_DATA_SIZE:
        last_path = "verbatim"
        body = np.frombuffer(buf, dtype=udt, count=remaining_len,
                             offset=METADATA_LEN_RLE)
        rows = body.reshape(-1, ndims) if ndims else body.reshape(-1, 1)
        return _finish(rows, rows.shape[0], params)

    lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    idx, dense = _dec.index_and_gather(buf, ngroups, ndims, elem_sz,
                                       lowdim)

    ndata = dense.shape[0]
    nd_pad = next_bucket(max(ndata, 1))
    compact = (codec == "delta" and not params.materialize
               and params.op != Operation.NOOP)
    if compact and ndata == 0:
        # pure-run stream: every row is 0
        last_path = "compact"
        zero = np.zeros(ndims, np.int64)
        red, payload = zero, zero
    elif compact:
        last_path = "compact"
        gaps = np.zeros(nd_pad, np.int64)
        gaps[:ndata] = np.diff(idx.out_rows, prepend=-BLOCK_SZ) - BLOCK_SZ
        trailing = idx.total_rows - (int(idx.out_rows[-1]) + BLOCK_SZ)
        red = _compact_delta_pass(
            pad_rows(dense, nd_pad), pad_rows(idx.widths, nd_pad),
            jnp.asarray(gaps, jnp.int32), jnp.int32(trailing),
            jnp.int32(ndata), elem_sz, lowdim, params.op.value)
        payload = red
    else:
        last_path = "fused"
        rows_pad = next_bucket(max(idx.total_rows, 1))
        out_rows_p = np.full(nd_pad, rows_pad + BLOCK_SZ, dtype=np.int64)
        out_rows_p[:ndata] = idx.out_rows
        red, payload = _fused_pass(
            jnp.asarray(pad_rows(dense, nd_pad)),
            jnp.asarray(pad_rows(idx.widths, nd_pad)),
            jnp.asarray(out_rows_p, jnp.int32),
            jnp.int32(idx.total_rows),
            codec, elem_sz, lowdim, rows_pad, params.op.value,
            params.materialize)

    tail = np.frombuffer(buf, dtype=udt, count=remaining_len,
                         offset=idx.tail_offset)
    tail_rows = tail[: (remaining_len // ndims) * ndims].reshape(-1, ndims)

    res = QueryResult(data=None)
    if params.op != Operation.NOOP:
        dev = np.asarray(red).astype(np.int64)
        if params.op == Operation.REDUCE_MAX:
            if tail_rows.size:
                dev = np.maximum(dev, tail_rows.max(axis=0))
            res.max = dev.astype(udt)
        elif params.op == Operation.REDUCE_MIN:
            if idx.total_rows == 0:
                dev = np.full(ndims, np.iinfo(np.int64).max)
            if tail_rows.size:
                dev = np.minimum(dev, tail_rows.min(axis=0))
            res.min = dev.astype(udt)
        else:
            if tail_rows.size:
                dev = dev + tail_rows.sum(axis=0, dtype=np.int64)
            res.sum = dev
    if params.materialize:
        body = np.asarray(payload[: idx.total_rows]).astype(udt).reshape(-1)
        res.data = np.concatenate([body, tail]).reshape(-1, ndims) \
            if ndims else np.concatenate([body, tail])[:, None]
    return res


def _finish(rows: np.ndarray, nrows: int, params: QueryParams) -> QueryResult:
    res = QueryResult(data=rows if params.materialize else None)
    if params.op == Operation.REDUCE_MAX:
        res.max = rows.max(axis=0) if nrows else None
    elif params.op == Operation.REDUCE_MIN:
        res.min = rows.min(axis=0) if nrows else None
    elif params.op == Operation.REDUCE_SUM:
        res.sum = rows.sum(axis=0, dtype=np.int64) if nrows else None
    return res
