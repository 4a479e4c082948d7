"""Data-parallel multi-chip encode/decode over a jax.sharding.Mesh.

The reference is strictly single-threaded (SURVEY §2.10); this layer is the
multi-device scaling design mandated by the north star:

- **dp axis**: independent chunks of a stream (or independent streams) are
  sharded one-per-chip with ``shard_map``. Chunk boundaries carry the
  forecaster boundary state: for delta, each chunk's first row differences
  against the previous chunk's last row (obtained with ``ppermute``), so
  the *concatenated* decode is bit-identical to a single-stream decode.
- **offset scan**: per-shard compressed sizes are shared with
  ``all_gather``; an exclusive prefix sum gives each shard's byte offset
  in the final stream (deterministic stream layout without serialization).
- **decode prefix fixup**: each shard cumsums its local deltas, then adds
  the exclusive cross-shard prefix of per-shard row sums — a distributed
  prefix-sum, the codec analogue of sequence parallelism (SURVEY §5).

All collectives ride XLA (psum/all_gather/ppermute) inside ``shard_map``;
on a GPU mesh XLA lowers them to NCCL over NVLink. The mesh is one 1-D
``dp`` axis: every GPU of a host reaches every other at the same rate.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..constants import BLOCK_SZ
from ..models.forecasters import _fire_scan
from ..ops.bitmath import block_widths_rowmajor, header_value, sign_extend, zigzag_decode, zigzag_encode
from ..ops.pack import pack_rows_rowmajor, unpack_rows_rowmajor


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _gather(x) -> np.ndarray:
    """Sharded device output -> full numpy array on every process.

    Single-process: plain np.asarray. Multi-process (jax.distributed):
    the shards living on other hosts are not addressable locally, so an
    explicit cross-process all-gather assembles the global value — this
    is the "ordered gather" half of the north-star collective plan
    (SURVEY §2.10).
    """
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)


# ----------------------------------------------------------- FIRE chain


def _fire_chain(local_rows_or_errs: jnp.ndarray, elem_bits: int,
                decode: bool, truncate_coeffs: bool = True) -> jnp.ndarray:
    """Exact cross-shard FIRE scan via a serial state chain.

    FIRE's coefficient recurrence is inherently sequential over the
    stream (sprintz_xff_rle.cpp:147-152: one serial recurrence per
    column), so byte-exact multi-chip FIRE cannot shortcut the state. The
    chain runs n_dev steps: at step k every device scans its OWN blocks
    from its current incoming state and ``ppermute``s its final state one
    device rightward — so after step k, device k+1 holds the TRUE chain
    state, and each device captures the scan output produced at its own
    step. Wall-clock for the scan stage equals the single-chip scan (the
    recurrence is serial either way — the reference pays the same), while
    widths/pack/assembly stay fully parallel.

    Input (local_rows, D) int32: raw values (encode) or zigzag errors
    (decode); returns the same shape (errors / values).
    """
    n = jax.lax.axis_size("dp")
    my = jax.lax.axis_index("dp")
    nb = local_rows_or_errs.shape[0] // BLOCK_SZ
    blocks = local_rows_or_errs.reshape(
        nb, BLOCK_SZ, *local_rows_or_errs.shape[1:])
    # carry zeros derived from the input (mesh-varying axes must match)
    zero = jnp.zeros_like(blocks[0, 0])
    perm = [(i, (i + 1) % n) for i in range(n)]

    def step(carry, k):
        state, acc = carry
        out, fin = _fire_scan(
            blocks, elem_bits, truncate_coeffs, decode,
            init_state=state, return_final=True)
        acc = jnp.where(k == my, out, acc)
        state_next = tuple(
            jax.lax.ppermute(s, "dp", perm) for s in fin)
        return (state_next, acc), None

    (_, out), _ = jax.lax.scan(
        step, ((zero, zero, zero), jnp.zeros_like(blocks)),
        jnp.arange(n, dtype=jnp.int32))
    return out.reshape(local_rows_or_errs.shape)


# --------------------------------------------------------------- encode


def _shard_encode(rows: jnp.ndarray, elem_sz: int, codec: str):
    """Per-shard block encode. rows: (local_rows, D) int32."""
    eb = 8 * elem_sz
    if codec == "delta":
        # differencing against the previous chunk's last row keeps the
        # concatenated stream identical to single-chip encode
        prev_last = jax.lax.ppermute(
            rows[-1], "dp",
            [(i, (i + 1) % jax.lax.axis_size("dp"))
             for i in range(jax.lax.axis_size("dp"))])
        first_prev = jnp.where(jax.lax.axis_index("dp") == 0,
                               jnp.zeros_like(prev_last), prev_last)
        prev = jnp.concatenate([first_prev[None, :], rows[:-1]], axis=0)
        errs = zigzag_encode(sign_extend(rows - prev, eb), eb)
    else:
        # FIRE boundary state rides the serial ppermute chain — the
        # multi-chip stream is byte-identical to single-chip
        errs = _fire_chain(rows, eb, decode=False)
    nb = rows.shape[0] // BLOCK_SZ
    blocks = errs.reshape(nb, BLOCK_SZ, -1)
    ormask = jnp.bitwise_or.reduce(blocks, axis=1)
    widths = block_widths_rowmajor(ormask, elem_sz)
    dense = pack_rows_rowmajor(blocks, widths, elem_sz)
    hdr = header_value(widths, eb)
    # per-shard payload byte count and cross-shard exclusive offset scan
    nbytes = (BLOCK_SZ * ((widths.sum(axis=1) + 7) // 8)).sum()
    all_sizes = jax.lax.all_gather(nbytes, "dp")
    my = jax.lax.axis_index("dp")
    offset = jnp.where(jnp.arange(all_sizes.shape[0]) < my, all_sizes, 0).sum()
    return dense, widths, hdr, nbytes[None], offset[None]


def dp_encode(mesh: Mesh, rows: np.ndarray, elem_sz: int, codec: str = "delta"):
    """Sharded block-parallel encode pass.

    rows: (total_rows, D) with total_rows divisible by (n_devices * 8).
    Returns per-shard dense payloads, widths, headers, sizes and offsets;
    the host (or an ordered device gather) lays out the final stream.
    """
    n_dev = mesh.devices.size
    fn = shard_map_encode(mesh, elem_sz, codec)
    # numpy in: jit device_puts each process's addressable shards directly,
    # which works unchanged under multi-process meshes (host-replicated data)
    return fn(np.asarray(rows, np.int32))


@functools.lru_cache(maxsize=None)
def _shard_map_encode_cached(mesh: Mesh, elem_sz: int, codec: str):
    f = functools.partial(_shard_encode, elem_sz=elem_sz, codec=codec)
    mapped = jax.shard_map(
        f, mesh=mesh,
        in_specs=(P("dp", None),),
        out_specs=(P("dp"), P("dp"), P("dp"), P("dp"), P("dp")),
    )
    return jax.jit(mapped)


def shard_map_encode(mesh: Mesh, elem_sz: int, codec: str):
    return _shard_map_encode_cached(mesh, elem_sz, codec)


# --------------------------------------------------------------- decode


def _shard_decode(dense: jnp.ndarray, widths: jnp.ndarray, elem_sz: int):
    """Per-shard delta decode with distributed prefix fixup.

    dense: (local_nb, 8, MAXB) int32; widths: (local_nb, D) int32.
    """
    eb = 8 * elem_sz
    errs = unpack_rows_rowmajor(dense, widths, elem_sz=elem_sz)
    nb, _, ndims = errs.shape
    deltas = zigzag_decode(errs.reshape(nb * BLOCK_SZ, ndims), eb)
    local = jnp.cumsum(deltas, axis=0, dtype=jnp.int32)
    # exclusive cross-shard prefix of per-shard delta sums
    shard_sum = local[-1]
    all_sums = jax.lax.all_gather(shard_sum, "dp")  # (n_dev, D)
    my = jax.lax.axis_index("dp")
    prefix = jnp.where(
        (jnp.arange(all_sums.shape[0]) < my)[:, None], all_sums, 0).sum(axis=0)
    return (local + prefix[None, :]) & ((1 << eb) - 1)


@functools.lru_cache(maxsize=None)
def _shard_map_decode_cached(mesh: Mesh, elem_sz: int):
    f = functools.partial(_shard_decode, elem_sz=elem_sz)
    mapped = jax.shard_map(
        f, mesh=mesh,
        in_specs=(P("dp"), P("dp")),
        out_specs=P("dp"),
    )
    return jax.jit(mapped)


def dp_delta_decode(mesh: Mesh, dense: np.ndarray, widths: np.ndarray,
                    elem_sz: int):
    """Block-parallel delta decode: local unpack+cumsum, prefix fixup."""
    fn = _shard_map_decode_cached(mesh, elem_sz)
    return fn(np.asarray(dense, np.int32), np.asarray(widths, np.int32))


def _shard_fire_decode(dense: jnp.ndarray, widths: jnp.ndarray,
                       elem_sz: int):
    """Per-shard unpack + exact cross-shard FIRE decode chain."""
    eb = 8 * elem_sz
    errs = unpack_rows_rowmajor(dense, widths, elem_sz=elem_sz)
    nb, _, ndims = errs.shape
    return _fire_chain(errs.reshape(nb * BLOCK_SZ, ndims), eb, decode=True)


@functools.lru_cache(maxsize=None)
def _shard_map_fire_decode_cached(mesh: Mesh, elem_sz: int):
    f = functools.partial(_shard_fire_decode, elem_sz=elem_sz)
    mapped = jax.shard_map(
        f, mesh=mesh, in_specs=(P("dp"), P("dp")), out_specs=P("dp"))
    return jax.jit(mapped)


def dp_fire_decode(mesh: Mesh, dense: np.ndarray, widths: np.ndarray,
                   elem_sz: int):
    """Block-parallel unpack + serial-chain FIRE reconstruction."""
    fn = _shard_map_fire_decode_cached(mesh, elem_sz)
    return fn(np.asarray(dense, np.int32), np.asarray(widths, np.int32))


# ------------------------------------------------- decode from stream bytes


def _shard_delta_rows(errs_zz: jnp.ndarray, elem_sz: int):
    """Row-sharded delta reconstruction over the full timeline.

    errs_zz: (local_rows, D) int32 zigzag errors (run rows hold 0, which
    contributes zero delta — exactly the run semantics). Local cumsum +
    exclusive cross-shard prefix of per-shard delta sums.
    """
    eb = 8 * elem_sz
    deltas = zigzag_decode(errs_zz, eb)
    local = jnp.cumsum(deltas, axis=0, dtype=jnp.int32)
    shard_sum = local[-1]
    all_sums = jax.lax.all_gather(shard_sum, "dp")
    my = jax.lax.axis_index("dp")
    prefix = jnp.where(
        (jnp.arange(all_sums.shape[0]) < my)[:, None], all_sums, 0).sum(axis=0)
    return (local + prefix[None, :]) & ((1 << eb) - 1)


@functools.lru_cache(maxsize=None)
def _shard_map_rows_cached(mesh: Mesh, elem_sz: int, codec: str):
    if codec == "delta":
        f = functools.partial(_shard_delta_rows, elem_sz=elem_sz)
    else:
        f = functools.partial(_fire_chain, elem_bits=8 * elem_sz,
                              decode=True)
    mapped = jax.shard_map(f, mesh=mesh, in_specs=(P("dp"),),
                           out_specs=P("dp"))
    return jax.jit(mapped)


def _shard_decode_timeline(dense_k, widths_k, src_k, state_k, *, codec,
                           elem_sz, lowdim, use_state):
    """Per-device fused decode: unpack + block-gather timeline + local
    reconstruction. Everything heavy stays on this shard — no host
    scatter, no full-array replication (VERDICT r2 item 4).

    dense_k: (nb_per, 8|D, MAXB|EB) i32 payload bytes of the data blocks
    whose rows fall in this shard's timeline span; src_k: (nbt_per,) i32
    local data-block index per timeline block (nb_per = run/pad
    sentinel -> zero errors); state_k: (3, D) forecaster state entering
    the span (used when ``use_state``: FIRE with sidecar checkpoints —
    no serial cross-device chain).
    """
    from .. import decoder as _dec
    from ..models.forecasters import fire_decode

    eb = 8 * elem_sz
    d = dense_k.astype(jnp.int32)
    w = widths_k.astype(jnp.int32)
    if lowdim:
        errs = _dec._unpack_lowdim_best(d, w)
    else:
        errs = unpack_rows_rowmajor(d, w, elem_sz=elem_sz)
    nb, _, ndims = errs.shape
    errs_pad = jnp.concatenate(
        [errs, jnp.zeros((1, BLOCK_SZ, ndims), errs.dtype)])
    full = errs_pad[src_k].reshape(src_k.shape[0] * BLOCK_SZ, ndims)
    if codec == "delta":
        deltas = zigzag_decode(full, eb)
        local = jnp.cumsum(deltas, axis=0, dtype=jnp.int32)
        # exclusive cross-shard prefix of per-shard sums (padding rows
        # contribute zero delta, so uneven spans stay exact)
        shard_sum = local[-1]
        all_sums = jax.lax.all_gather(shard_sum, "dp")
        my = jax.lax.axis_index("dp")
        prefix = jnp.where((jnp.arange(all_sums.shape[0]) < my)[:, None],
                           all_sums, 0).sum(axis=0)
        vals = (local + prefix[None, :]) & ((1 << eb) - 1)
    elif use_state:
        # sidecar states make shards independent: each enters at its
        # recorded (prev, prev_delta, counter) — the multi-chip
        # realization of jump() (online.hpp:126-132), replacing the
        # n_dev-times-redundant serial ppermute chain
        vals = fire_decode(full, eb, truncate_coeffs=not lowdim,
                           init_state=(state_k[0], state_k[1], state_k[2]))
    else:
        vals = _fire_chain(full, eb, decode=True,
                           truncate_coeffs=not lowdim)
    return vals.astype(jnp.uint8 if elem_sz == 1 else jnp.uint16)


@functools.lru_cache(maxsize=None)
def _shard_map_timeline_cached(mesh: Mesh, codec: str, elem_sz: int,
                               lowdim: bool, use_state: bool):
    f = functools.partial(_shard_decode_timeline, codec=codec,
                          elem_sz=elem_sz, lowdim=lowdim,
                          use_state=use_state)
    mapped = jax.shard_map(
        f, mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp"), P("dp")),
        out_specs=P("dp"))
    return jax.jit(mapped)


def dp_decompress(mesh: Mesh, buf: bytes, codec: str = "delta",
                  elem_sz: int = 1, sidecar=None, out: str = "numpy"):
    """Sharded decode of a real compressed stream (north-star decode side).

    Pipeline (SURVEY §2.10 decode plan; VERDICT r2 item 4):
    1. host: header walk — segment-parallel (threaded native walkers)
       when a sidecar provides checkpoint offsets, serial otherwise;
    2. host: native payload gather into the dense block buffer;
    3. device, ONE shard_map over the row timeline: per-shard payload
       unpack + block-gather timeline (run rows = zero errors, no host
       scatter) + reconstruction — delta via local cumsum + all-gather
       prefix fixup; FIRE via per-shard
       sidecar states (independent shards) or, without a sidecar, the
       exact serial ppermute chain.

    Shard spans follow sidecar checkpoint rows for FIRE (states are only
    known there) and split evenly otherwise. Output is bit-identical to
    ``decoder.decompress``. Works for row-major AND lowdim layouts.

    ``out="numpy"`` returns the flat element array (host-gathered);
    ``out="sharded"`` returns ``(vals, spans, total_rows, tail)`` with
    ``vals`` the global sharded device array ((n_dev * rows_per, D),
    rows_per*k + [0, spans[k]) valid) — no full-array replication.
    """
    from .. import decoder as _dec
    from ..constants import LOWDIM_MAX_NDIMS, METADATA_LEN_RLE, MIN_DATA_SIZE
    from ..golden.stream import read_metadata_rle
    from ..utils.shapes import next_bucket

    udt = np.uint8 if elem_sz == 1 else np.uint16
    ngroups, remaining_len, ndims = read_metadata_rle(buf)
    if ngroups == 0 and remaining_len < MIN_DATA_SIZE:
        return np.frombuffer(buf, dtype=udt, count=remaining_len,
                             offset=METADATA_LEN_RLE).copy()
    n_dev = mesh.devices.size
    lowdim = ndims <= LOWDIM_MAX_NDIMS[elem_sz]
    if sidecar is not None:
        idx = _dec.walk_headers_parallel(
            buf, ngroups, ndims, elem_sz, sidecar.byte_offsets,
            sidecar.row_offsets, sidecar.every_groups, lowdim=lowdim)
        dense = _dec.gather_payloads(buf, idx, ndims, elem_sz, lowdim)
    else:
        # fused overlapped walk+gather (decoder.index_and_gather)
        idx, dense = _dec.index_and_gather(buf, ngroups, ndims, elem_sz,
                                           lowdim)
    ndata = idx.widths.shape[0]
    tail = np.frombuffer(buf, dtype=udt, count=remaining_len,
                         offset=idx.tail_offset)
    if idx.total_rows == 0:
        return tail.copy()

    nbt = -(-idx.total_rows // BLOCK_SZ)
    use_state = codec == "xff" and sidecar is not None and len(
        sidecar.row_offsets) > 1
    if use_state:
        # shard boundaries snap to checkpoint rows (states known there)
        targets = (np.arange(1, n_dev) * nbt * BLOCK_SZ) // n_dev
        ck = np.unique(np.searchsorted(
            sidecar.row_offsets, targets, side="right") - 1)
        ck = ck[ck > 0]
        brows = np.concatenate(
            [[0], sidecar.row_offsets[ck],
             np.full(n_dev - 1 - len(ck), nbt * BLOCK_SZ),
             [nbt * BLOCK_SZ]]).astype(np.int64)
        states = np.zeros((n_dev, 3, ndims), np.int32)
        states[1 : 1 + len(ck), : sidecar.states.shape[1]] = \
            sidecar.states[ck]
    else:
        per = -(-nbt // n_dev)
        brows = np.minimum(np.arange(n_dev + 1) * per, nbt) * BLOCK_SZ
        states = np.zeros((n_dev, 3, ndims), np.int32)
    spans = np.diff(brows)

    # per-shard data blocks: out_rows is sorted, so each shard's blocks
    # are one contiguous slice
    lo = np.searchsorted(idx.out_rows, brows[:-1], side="left")
    hi = np.searchsorted(idx.out_rows, brows[1:], side="left")
    nb_per = next_bucket(max(int((hi - lo).max()), 1))
    if use_state or codec == "delta":
        # padding at shard tails is harmless (zero deltas / per-shard
        # states), so bucket for jit reuse
        nbt_per = next_bucket(max(int(-(-spans.max() // BLOCK_SZ)), 1))
    else:
        # FIRE without sidecar rides the serial state chain: inner
        # shards must be UNPADDED (zero-error padding blocks would
        # advance the carried state), so spans stay exact — padding
        # lands only on the final shard's tail
        nbt_per = max(int(-(-spans.max() // BLOCK_SZ)), 1)
    dense_s = np.zeros((n_dev, nb_per) + dense.shape[1:], np.uint8)
    widths_s = np.zeros((n_dev, nb_per, ndims), np.int32)
    src_s = np.full((n_dev, nbt_per), nb_per, np.int32)
    for k in range(n_dev):
        nk = hi[k] - lo[k]
        dense_s[k, :nk] = dense[lo[k] : hi[k]]
        widths_s[k, :nk] = idx.widths[lo[k] : hi[k]]
        tb = (idx.out_rows[lo[k] : hi[k]] - brows[k]) // BLOCK_SZ
        src_s[k, tb] = np.arange(nk, dtype=np.int32)

    fn = _shard_map_timeline_cached(mesh, codec, elem_sz, lowdim, use_state)
    vals = fn(dense_s.reshape((n_dev * nb_per,) + dense.shape[1:]),
              widths_s.reshape(n_dev * nb_per, ndims),
              src_s.reshape(-1),
              states.reshape(n_dev * 3, ndims))
    if out == "sharded":
        return vals, spans, idx.total_rows, tail
    vals = _gather(vals).reshape(n_dev, nbt_per * BLOCK_SZ, ndims)
    body = np.concatenate(
        [vals[k, : spans[k]] for k in range(n_dev)]).astype(udt)
    return np.concatenate([body.reshape(-1), tail])



@functools.lru_cache(maxsize=None)
def _compact_take_cached(bucket: int):
    return jax.jit(lambda d, i: d[i, :, :bucket].astype(jnp.uint8))


def gather_dense_compact(dense, widths_np: np.ndarray,
                         elem_sz: int) -> np.ndarray:
    """Gather a sharded (nb, 8, MAXB) payload tensor moving ~compressed
    bytes instead of the dense uncompressed-sized tensor (SURVEY §2.10 /
    VERDICT r3 item 6).

    Blocks are bucketed by payload row bytes rb = ceil(sum(widths)/8)
    rounded to multiples of 8 (<= MAXB/8 buckets, jit-reused pow2 index
    shapes); each bucket is sliced to its width ON DEVICE (major-axis
    take + static lane slice — the fast gather shape) so the
    device->host (or cross-process) hop carries <= rb+8 bytes per packed
    row. Zero-width blocks (runs) move nothing. The host reassembles
    the (nb, 8, MAXB) layout for the stream assembler with bucket-sized
    numpy copies.
    """
    from ..utils.shapes import next_bucket

    nb, bsz, maxb = dense.shape
    rb = (widths_np.sum(axis=1, dtype=np.int64) + 7) // 8
    rbb = np.minimum((rb + 7) // 8 * 8, maxb)
    dense_np = np.zeros((nb, bsz, maxb), np.uint8)
    for bucket in np.unique(rbb):
        if bucket == 0:
            continue
        idx = np.nonzero(rbb == bucket)[0]
        npad = next_bucket(len(idx))
        idxp = np.zeros(npad, np.int32)
        idxp[: len(idx)] = idx
        part = _gather(_compact_take_cached(int(bucket))(
            dense, jnp.asarray(idxp)))
        dense_np[idx, :, :bucket] = part[: len(idx)]
    return dense_np


# --------------------------------------------------------------- full step


def dp_compress(mesh: Mesh, flat: np.ndarray, ndims: int,
                codec: str = "delta") -> bytes:
    """Multi-chip encode producing the byte-exact single-stream output.

    Blocks are sharded across the mesh; forecaster boundary state rides
    ``ppermute`` — a one-row handoff for delta, the serial state chain
    for FIRE (``_fire_chain``) — so the per-block errors/widths equal the
    single-chip pass for BOTH codecs and the assembled stream is
    byte-identical to ``encoder.compress``. The emission plan (RLE runs
    can cross shard boundaries) and final layout run on host over the
    gathered per-block summaries — the "ordered gather of packed shards"
    of the north star.
    """
    from .. import encoder as _enc
    from ..constants import MIN_DATA_SIZE
    from ..golden.stream import write_metadata_rle
    from ..planner import build_plan

    flat = np.ascontiguousarray(flat)
    elem_sz = flat.dtype.itemsize
    n = flat.size
    if n < MIN_DATA_SIZE:
        return write_metadata_rle(0, n, ndims) + flat.tobytes()
    n_dev = mesh.devices.size
    block_elems = BLOCK_SZ * ndims
    nb_max = n // block_elems
    # pad blocks to a multiple of the mesh so every real block is encoded
    # (padding rows are zeros at the end and never referenced by the plan)
    nb_pad = -(-nb_max // n_dev) * n_dev
    rows = np.zeros((nb_pad * BLOCK_SZ, ndims), dtype=np.int32)
    rows[: nb_max * BLOCK_SZ] = flat[: nb_max * block_elems].reshape(
        -1, ndims)

    dense, widths, hdr, sizes, offsets = dp_encode(
        mesh, rows, elem_sz, codec)
    # headers are 1 byte/dim and widths derive from them (value eb-1
    # stores width eb), so the only wide gather left is the bucketed
    # compact payload — host traffic ~ compressed stream size, not the
    # dense uncompressed-sized tensor (VERDICT r3 item 6)
    hdr_np = _gather(hdr.astype(jnp.uint8))
    eb = 8 * elem_sz
    widths_np = hdr_np.astype(np.int32)
    widths_np[widths_np == eb - 1] = eb
    dense_np = gather_dense_compact(dense, widths_np, elem_sz)
    zero_flags = np.asarray(widths_np.sum(axis=1) == 0)[:nb_max]

    plan = build_plan(zero_flags, n, ndims, codec == "xff")
    return _enc.assemble_stream(
        plan, widths_np, hdr_np, dense_np, ndims, elem_sz, False,
        flat[n - plan.remaining_elems:])


def training_step(mesh: Mesh, rows: np.ndarray, elem_sz: int = 1,
                  codec: str = "delta"):
    """One full sharded encode->decode round-trip step (the framework's
    analogue of a model's train step): returns (decoded rows, total bytes).
    Used by the multichip dry run and scaling benchmarks."""
    dense, widths, hdr, sizes, offsets = dp_encode(mesh, rows, elem_sz, codec)
    if codec == "delta":
        decoded = dp_delta_decode(mesh, dense, widths, elem_sz)
    else:
        # exact FIRE reconstruction via the serial ppermute state chain
        decoded = dp_fire_decode(mesh, dense, widths, elem_sz)
    total_bytes = np.asarray(sizes).sum()
    return decoded, total_bytes
