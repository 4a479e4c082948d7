"""Multi-host initialization and mesh construction.

The reference is single-threaded (SURVEY §2.10); this rebuild scales by
dp sharding over a Mesh (shard.py). This module supplies the multi-host
framing mandated by SURVEY §2.10: jax.distributed bring-up from the
standard JAX coordination env vars, and meshes that span all hosts'
devices.

On a single process (this environment, and the CPU test mesh) everything
degrades to local devices — the shard_map programs in shard.py are
identical either way, which is the point: the SPMD program is written
once and the runtime scales it.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def maybe_init_distributed() -> bool:
    """Initialize jax.distributed when cluster env vars are present.

    Recognizes the standard JAX coordination variables
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID), all
    three of which must be set. Returns True when a multi-process runtime
    was initialized. Safe to call repeatedly.
    """
    if jax.process_count() > 1:
        return True  # already initialized
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    if addr and nproc and pid:
        jax.distributed.initialize(
            coordinator_address=addr,
            num_processes=int(nproc),
            process_id=int(pid),
        )
        return True
    return False


def global_mesh(axis: str = "dp") -> Mesh:
    """A 1-D mesh over every device of every participating host.

    Sharded encode/decode (shard.py) over this mesh gives each host's
    devices a contiguous block range, so the ppermute boundary handoffs
    are neighbor exchanges and at most one per host boundary crosses the
    network; within a host the collectives ride NVLink.
    """
    return Mesh(np.array(jax.devices()), (axis,))


def host_local_rows(total_rows: int, block_rows: int = 8) -> slice:
    """The row range this process should feed into dp_encode under a
    global mesh: contiguous, block-aligned, in process order (so the
    concatenated stream equals the single-host stream)."""
    nproc = jax.process_count()
    pid = jax.process_index()
    blocks = total_rows // block_rows
    per = -(-blocks // nproc)
    lo = min(pid * per, blocks) * block_rows
    hi = min((pid + 1) * per, blocks) * block_rows
    return slice(lo, hi)


# ------------------------------------------------ multi-process encode/decode
#
# The reference is a single-threaded library (SURVEY §2.10); these are the
# jax.distributed-native entry points: every participating process holds
# only its host-local slice of the input, the shard_map encode runs over
# the global mesh (collectives within hosts and across them), and
# the byte stream each process assembles is identical to the single-chip
# ``encoder.compress`` output.


def host_local_elems(total_len: int, ndims: int,
                     n_dev: int | None = None) -> slice:
    """The element range this process must pass to ``mp_compress``.

    Contiguous and block-aligned per process, mirroring dp_compress's
    device padding (blocks padded to a multiple of the global device
    count, split evenly across processes); the last process additionally
    owns the sub-block tail.
    """
    from ..constants import BLOCK_SZ

    nproc = jax.process_count()
    pid = jax.process_index()
    n_dev = n_dev or jax.device_count()
    block_elems = BLOCK_SZ * ndims
    nb_max = total_len // block_elems
    nb_pad = -(-nb_max // n_dev) * n_dev if nb_max else 0
    bpp = nb_pad // nproc
    lo = min(pid * bpp * block_elems, total_len)
    hi = min((pid + 1) * bpp * block_elems, total_len)
    if pid == nproc - 1:
        hi = total_len
    return slice(lo, hi)


def _allgather_window(local_flat: np.ndarray, lo: int, t0: int,
                      t1: int) -> np.ndarray:
    """Assemble elements [t0, t1) of the global flat array on every
    process from non-overlapping host-local slices (each element is owned
    by exactly one process, so a sum across the gathered buffers is an
    exact merge)."""
    buf = np.zeros(t1 - t0, dtype=local_flat.dtype)
    s0 = max(t0, lo)
    s1 = min(t1, lo + local_flat.size)
    if s1 > s0:
        buf[s0 - t0: s1 - t0] = local_flat[s0 - lo: s1 - lo]
    if jax.process_count() == 1:
        return buf
    from jax.experimental import multihost_utils
    parts = np.asarray(multihost_utils.process_allgather(buf))
    return parts.sum(axis=0).astype(local_flat.dtype)


def mp_compress(local_flat: np.ndarray, total_len: int, ndims: int,
                codec: str = "delta", mesh: Mesh | None = None) -> bytes:
    """Multi-process encode over distributed input (north-star encode).

    Each process passes only ``flat[host_local_elems(total_len, ndims)]``;
    the global blocks array is built with per-process shards
    (``jax.make_array_from_process_local_data``), the shard_map encode
    runs once over the whole mesh (delta boundary rows / FIRE state ride
    ``ppermute`` exactly as in ``shard.dp_compress``), per-block summaries
    are all-gathered, and every process assembles the identical byte
    stream. Byte-exact vs ``encoder.compress`` for delta AND xff.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .. import encoder as _enc
    from ..constants import BLOCK_SZ, MIN_DATA_SIZE
    from ..golden.stream import write_metadata_rle
    from ..planner import build_plan
    from .shard import _gather, gather_dense_compact, shard_map_encode

    mesh = mesh or global_mesh()
    n_dev = mesh.devices.size
    nproc = jax.process_count()
    elem_sz = local_flat.dtype.itemsize
    n = total_len
    sl = host_local_elems(n, ndims, n_dev)
    lo = sl.start
    if local_flat.size != sl.stop - lo:
        raise ValueError(
            f"process {jax.process_index()} must pass elements "
            f"[{lo}, {sl.stop}) = {sl.stop - lo} elems, "
            f"got {local_flat.size}")
    if n < MIN_DATA_SIZE:
        tail = _allgather_window(local_flat, lo, 0, n)
        return write_metadata_rle(0, n, ndims) + tail.tobytes()

    block_elems = BLOCK_SZ * ndims
    nb_max = n // block_elems
    nb_pad = -(-nb_max // n_dev) * n_dev
    bpp = nb_pad // nproc
    local_rows = np.zeros((bpp * BLOCK_SZ, ndims), np.int32)
    nfull = min(sl.stop, nb_max * block_elems) - lo
    nfull -= nfull % block_elems  # the last process's slice includes the tail
    if nfull > 0:
        local_rows.reshape(-1)[:nfull] = local_flat[:nfull]
    sharding = NamedSharding(mesh, P("dp", None))
    rows = jax.make_array_from_process_local_data(sharding, local_rows)

    dense, widths, hdr, sizes, offsets = shard_map_encode(
        mesh, elem_sz, codec)(rows)
    # widths derive from the 1-byte headers; the payload rides the
    # bucketed compact gather — cross-process traffic ~ stream size
    import jax.numpy as jnp
    hdr_np = _gather(hdr.astype(jnp.uint8))
    eb = 8 * elem_sz
    widths_np = hdr_np.astype(np.int32)
    widths_np[widths_np == eb - 1] = eb
    dense_np = gather_dense_compact(dense, widths_np, elem_sz)
    zero_flags = (widths_np.sum(axis=1) == 0)[:nb_max]

    plan = build_plan(zero_flags, n, ndims, codec == "xff")
    tail = _allgather_window(local_flat, lo, n - plan.remaining_elems, n)
    return _enc.assemble_stream(
        plan, widths_np, hdr_np, dense_np, ndims, elem_sz, False, tail)


def mp_decompress(buf: bytes, codec: str = "delta", elem_sz: int = 1,
                  mesh: Mesh | None = None) -> np.ndarray:
    """Multi-process sharded decode of a compressed stream.

    The stream bytes are host-replicated input (every process reads the
    same stream — it is the compressed artifact); the header walk runs on
    each host, payload unpack and timeline reconstruction are sharded
    over the global mesh, and the full decoded output is all-gathered to
    every process. Identical result to ``decoder.decompress``.
    """
    from .shard import dp_decompress

    return dp_decompress(mesh or global_mesh(), buf, codec, elem_sz)
