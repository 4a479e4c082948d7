"""ctypes loader for the native host runtime (native/sprintz_host.cpp).

The planner and header walk are sequential per-block bookkeeping loops —
the only host-side hot paths. They're compiled on demand with g++ into a
cache directory; every entry point has a pure-Python fallback, and a
shared test suite asserts native == Python on random streams.

Set ``SPRINTZ_NO_NATIVE=1`` to force the Python implementations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent.parent / "native" / "sprintz_host.cpp"
_lib = None
_tried = False
# Filled in by get_lib(): the loaded library's path, and whether it was
# built with -march=native (False: the portable build).
lib_path: str | None = None
march_native = False


def _compile(src: bytes, flags: list[str]) -> pathlib.Path | None:
    """Build (or find already built) the library for ``flags``; None when
    the compiler refuses them."""
    tag = hashlib.sha256(src + repr(flags).encode()).hexdigest()[:16]
    cache = pathlib.Path(
        os.environ.get("SPRINTZ_NATIVE_CACHE",
                       os.path.join(tempfile.gettempdir(), "sprintz_native")))
    cache.mkdir(parents=True, exist_ok=True)
    so = cache / f"sprintz_host_{tag}.so"
    if so.exists():
        return so
    # per-process tmp name: concurrent builders (e.g. xdist workers)
    # must not share an output path or one replaces the other's
    # half-written object
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run(["g++", *flags, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        pass
    finally:
        tmp.unlink(missing_ok=True)
    return so if so.exists() else None  # a racing builder may have won


def _build() -> ctypes.CDLL | None:
    global lib_path, march_native
    if not _SRC.exists():
        return None
    src = _SRC.read_bytes()
    # -march=native: the library is compiled on demand on the deployment
    # host, so host-specific ISA (BMI2 PDEP walk, AVX2 masked gather) is
    # safe; a toolchain without it falls back to a portable build, and
    # the source guards every intrinsic path. SPRINTZ_NATIVE_MARCH=0
    # forces the portable build.
    base = ["-std=c++17", "-O3", "-fPIC", "-shared", "-pthread"]
    variants = [base]
    if os.environ.get("SPRINTZ_NATIVE_MARCH", "1") != "0":
        variants.insert(0, base + ["-march=native"])
    for flags in variants:
        so = _compile(src, flags)
        if so is None:
            continue
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            continue
        lib_path = str(so)
        march_native = "-march=native" in flags
        return lib
    return None


def get_lib() -> ctypes.CDLL | None:
    global _lib, _tried
    if os.environ.get("SPRINTZ_NO_NATIVE"):
        return None
    if not _tried:
        _tried = True
        _lib = _build()
    return _lib


def build_plan_native(zero_flags: np.ndarray, n_elems: int, ndims: int,
                      run_cmp_allows_equal: bool):
    """Native build_plan; returns (kinds, values, ngroups, consumed, remaining)
    or None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    zf = np.ascontiguousarray(zero_flags, dtype=np.uint8)
    cap = 2 * max(zf.size, 1) + 4
    kinds = np.empty(cap, dtype=np.int8)
    values = np.empty(cap, dtype=np.int32)
    meta = np.zeros(4, dtype=np.int64)
    fn = lib.sprintz_build_plan
    fn.restype = ctypes.c_int64
    nslots = fn(
        zf.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(n_elems),
        ctypes.c_int32(ndims), ctypes.c_int32(int(run_cmp_allows_equal)),
        kinds.ctypes.data_as(ctypes.c_void_p),
        values.ctypes.data_as(ctypes.c_void_p),
        meta.ctypes.data_as(ctypes.c_void_p))
    assert nslots <= cap
    return (kinds[:nslots].copy(), values[:nslots].copy(),
            int(meta[1]), int(meta[2]), int(meta[3]))


def pad_stream(buf: bytes) -> np.ndarray:
    """One-byte-padded u8 view of a stream for the native walker (its
    2-byte header loads may touch one byte past the region end; bounds
    are enforced against the REAL length inside). Build this ONCE when
    walking many segments of the same buffer — ``buf + b"\\x00"`` copies
    the whole stream."""
    data = np.empty(len(buf) + 1, dtype=np.uint8)
    data[:-1] = np.frombuffer(buf, dtype=np.uint8)
    data[-1] = 0
    return data


def walk_headers_native(buf: bytes, start: int, ngroups: int, ndims: int,
                        elem_sz: int, lowdim: bool,
                        padded: np.ndarray | None = None):
    """Native walk_headers; returns (widths, offsets, out_rows, total_rows,
    tail_offset) or None if the native lib is unavailable.

    Raises CorruptStreamError when the walk would overrun the buffer.
    """
    lib = get_lib()
    if lib is None:
        return None
    data = pad_stream(buf) if padded is None else padded
    ndata_max = int(ngroups) * 2
    # u8 widths (max legal width is 16): 4x less walk/compact traffic and
    # 4x less host->device transfer than int32
    widths = np.empty((max(ndata_max, 1), ndims), dtype=np.uint8)
    offsets = np.empty(max(ndata_max, 1), dtype=np.int64)
    out_rows = np.empty(max(ndata_max, 1), dtype=np.int64)
    meta = np.zeros(3, dtype=np.int64)
    fn = lib.sprintz_walk_headers
    fn.restype = ctypes.c_int64
    ndata = fn(
        data.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(data.size - 1),
        ctypes.c_int64(start),
        ctypes.c_int64(ngroups), ctypes.c_int32(ndims),
        ctypes.c_int32(elem_sz), ctypes.c_int32(int(lowdim)),
        widths.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        out_rows.ctypes.data_as(ctypes.c_void_p),
        meta.ctypes.data_as(ctypes.c_void_p))
    if ndata < 0:
        from .errors import CorruptStreamError

        raise CorruptStreamError(
            "stream walk overran the buffer: truncated stream or "
            "inconsistent metadata")
    return (widths[:ndata].copy(), offsets[:ndata].copy(),
            out_rows[:ndata].copy(), int(meta[1]), int(meta[2]))


def walk_headers_parallel_native(buf: bytes, byte_offsets: np.ndarray,
                                 row_offsets: np.ndarray,
                                 every_groups: int, ngroups: int,
                                 ndims: int, elem_sz: int, lowdim: bool):
    """Native segment-parallel walk (std::threads over sidecar
    checkpoints). Same contract as walk_headers_native, or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "sprintz_walk_headers_parallel"):
        return None
    data = pad_stream(buf)
    nseg = len(byte_offsets)
    ndata_max = int(ngroups) * 2
    widths = np.empty((max(ndata_max, 1), ndims), dtype=np.uint8)
    offsets = np.empty(max(ndata_max, 1), dtype=np.int64)
    out_rows = np.empty(max(ndata_max, 1), dtype=np.int64)
    meta = np.zeros(3, dtype=np.int64)
    bo = np.ascontiguousarray(byte_offsets, np.int64)
    ro = np.ascontiguousarray(row_offsets, np.int64)
    fn = lib.sprintz_walk_headers_parallel
    fn.restype = ctypes.c_int64
    ndata = fn(
        data.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(data.size - 1),
        bo.ctypes.data_as(ctypes.c_void_p),
        ro.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(nseg), ctypes.c_int64(every_groups),
        ctypes.c_int64(ngroups), ctypes.c_int32(ndims),
        ctypes.c_int32(elem_sz), ctypes.c_int32(int(lowdim)),
        widths.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        out_rows.ctypes.data_as(ctypes.c_void_p),
        meta.ctypes.data_as(ctypes.c_void_p))
    if ndata < 0:
        from .errors import CorruptStreamError

        raise CorruptStreamError(
            "stream walk overran the buffer" if ndata == -1 else
            "sidecar inconsistent with stream: segment row counts do not "
            "stitch to the recorded row offsets")
    return (widths[:ndata].copy(), offsets[:ndata].copy(),
            out_rows[:ndata].copy(), int(meta[1]), int(meta[2]))


def walk_gather_native(buf: bytes, start: int, ngroups: int, ndims: int,
                       elem_sz: int, maxb: int,
                       pad_to_bucket: bool = False):
    """Fused overlapped walk+gather (rowmajor): the walker thread indexes
    blocks while worker threads copy their payload rows cache-hot —
    wall ~ max(walk, gather) instead of the sum.

    ``maxb`` is the dense row-stride guess; returns None if the native
    lib is unavailable, -3-style retry is handled by the CALLER (returns
    the int -3 so the caller can re-bucket). Success: (widths, offsets,
    out_rows, total_rows, tail_offset, dense).

    ``pad_to_bucket``: return ``dense`` with ``next_bucket(ndata)``
    leading rows (tail zeroed) instead of exactly ``ndata`` — the
    downstream ``pad_rows`` + flat-param ``ascontiguousarray`` then
    no-op instead of re-copying the whole multi-MB dense buffer (the
    dominant host-prep cost of the composed decode pipeline). The
    over-allocation is free: the walk buffer is already sized
    ``2 * ngroups`` rows.
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "sprintz_walk_gather"):
        return None
    data = pad_stream(buf)
    ndata_max = max(int(ngroups) * 2, 1)
    widths = np.empty((ndata_max, ndims), dtype=np.uint8)
    offsets = np.empty(ndata_max, dtype=np.int64)
    out_rows = np.empty(ndata_max, dtype=np.int64)
    dense = np.empty((ndata_max, 8, maxb), dtype=np.uint8)
    meta = np.zeros(3, dtype=np.int64)
    fn = lib.sprintz_walk_gather
    fn.restype = ctypes.c_int64
    ndata = fn(
        data.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(data.size - 1),
        ctypes.c_int64(start), ctypes.c_int64(ngroups),
        ctypes.c_int32(ndims), ctypes.c_int32(elem_sz),
        ctypes.c_int64(maxb),
        widths.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        out_rows.ctypes.data_as(ctypes.c_void_p),
        dense.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(dense.size),
        meta.ctypes.data_as(ctypes.c_void_p))
    if ndata == -3:
        return -3
    if ndata < 0:
        from .errors import CorruptStreamError

        raise CorruptStreamError(
            "stream walk overran the buffer: truncated stream or "
            "inconsistent metadata")
    nd_out = int(ndata)
    if pad_to_bucket and ndata:
        from .utils.shapes import next_bucket

        nd_pad = next_bucket(int(ndata))
        if nd_pad <= ndata_max:
            dense[ndata:nd_pad] = 0
            nd_out = nd_pad
    return (widths[:ndata].copy(), offsets[:ndata].copy(),
            out_rows[:ndata].copy(), int(meta[1]), int(meta[2]),
            dense[:nd_out])


def gather_blocks_native(buf: bytes, offsets: np.ndarray, rb: np.ndarray,
                         out: np.ndarray) -> bool:
    """Rowmajor block gather: 8 rows of rb[i] bytes at offsets[i] ->
    out[i] (ndata, 8, maxb). Unit indices computed inline in C (the
    generic path built ~3x-payload-size numpy index arrays first)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "sprintz_gather_blocks"):
        return False
    offs = np.ascontiguousarray(offsets, np.int64)
    rb = np.ascontiguousarray(rb, np.int64)
    data = np.frombuffer(buf, dtype=np.uint8)
    fn = lib.sprintz_gather_blocks
    fn.restype = ctypes.c_int64
    rc = fn(data.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(len(buf)),
            offs.ctypes.data_as(ctypes.c_void_p),
            rb.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(out.shape[0]), ctypes.c_int64(out.shape[2]),
            out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(out.nbytes))
    return rc == 0


def gather_dims_native(buf: bytes, offsets: np.ndarray, widths: np.ndarray,
                       out: np.ndarray) -> bool:
    """Lowdim block gather: ndims sections of widths[i, d] bytes each ->
    out[i] (ndata, D, EB)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "sprintz_gather_dims"):
        return False
    offs = np.ascontiguousarray(offsets, np.int64)
    w = np.ascontiguousarray(widths, np.int32)
    data = np.frombuffer(buf, dtype=np.uint8)
    fn = lib.sprintz_gather_dims
    fn.restype = ctypes.c_int64
    rc = fn(data.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(len(buf)),
            offs.ctypes.data_as(ctypes.c_void_p),
            w.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(out.shape[0]), ctypes.c_int32(out.shape[1]),
            ctypes.c_int64(out.shape[2]),
            out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(out.nbytes))
    return rc == 0


def gather_units_native(buf: bytes, unit_src: np.ndarray,
                        unit_dst: np.ndarray, unit_len: np.ndarray,
                        out: np.ndarray) -> bool:
    """Copy unit_len[i] bytes buf[unit_src[i]:] -> out.flat[unit_dst[i]:]
    for every unit (bounds-checked memcpys, threaded). Returns False if
    the native lib is unavailable or a unit is out of range."""
    lib = get_lib()
    if lib is None:
        return False
    src = np.ascontiguousarray(unit_src, np.int64)
    dst = np.ascontiguousarray(unit_dst, np.int64)
    ln = np.ascontiguousarray(unit_len, np.int64)
    data = np.frombuffer(buf, dtype=np.uint8)
    fn = lib.sprintz_gather_units
    fn.restype = ctypes.c_int64
    rc = fn(data.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(len(buf)),
            src.ctypes.data_as(ctypes.c_void_p),
            dst.ctypes.data_as(ctypes.c_void_p),
            ln.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(len(ln)),
            out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(out.nbytes))
    return rc == 0


def histogram_native(data: np.ndarray):
    """Native byte histogram; returns (256,) int64 counts or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "sprintz_histogram"):
        return None
    data = np.ascontiguousarray(data, np.uint8)
    counts = np.zeros(256, dtype=np.int64)
    lib.sprintz_histogram(
        data.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(data.size),
        counts.ctypes.data_as(ctypes.c_void_p))
    return counts


def huff_encode_native(data: np.ndarray, chunk_symbols: int,
                       codes: np.ndarray, lengths: np.ndarray):
    """Native chunked Huffman emit; returns (payload bytes, sizes u32)
    or None. Table construction stays in Python."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "sprintz_huff_encode"):
        return None
    data = np.ascontiguousarray(data, np.uint8)
    codes = np.ascontiguousarray(codes, np.uint32)
    lengths = np.ascontiguousarray(lengths, np.uint8)
    n = data.size
    nchunks = max(1, -(-n // chunk_symbols))
    # worst case: 12 bits/symbol + 1 tail byte per chunk
    cap = (n * 12) // 8 + nchunks + 64
    out = np.empty(cap, dtype=np.uint8)
    sizes = np.zeros(nchunks, dtype=np.uint32)
    fn = lib.sprintz_huff_encode
    fn.restype = ctypes.c_int64
    total = fn(
        data.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(n),
        ctypes.c_int64(chunk_symbols),
        codes.ctypes.data_as(ctypes.c_void_p),
        lengths.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(cap),
        sizes.ctypes.data_as(ctypes.c_void_p))
    if total < 0:
        return None
    return out[:total].tobytes(), sizes


def huff_decode_native(buf: bytes, offsets: np.ndarray, sizes: np.ndarray,
                       chunk_symbols: int, n: int,
                       sym_lut: np.ndarray, len_lut: np.ndarray):
    """Native table-driven Huffman decode; returns symbols (n,) u8 or
    None. Raises CorruptStreamError when a code overruns its payload."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "sprintz_huff_decode"):
        return None
    data = np.frombuffer(buf, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    sizes = np.ascontiguousarray(sizes, np.uint32)
    sym_lut = np.ascontiguousarray(sym_lut, np.uint8)
    len_lut = np.ascontiguousarray(len_lut, np.uint8)
    out = np.empty(max(n, 1), dtype=np.uint8)
    fn = lib.sprintz_huff_decode
    fn.restype = ctypes.c_int64
    r = fn(
        data.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        sizes.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(offsets)), ctypes.c_int64(chunk_symbols),
        ctypes.c_int64(n),
        sym_lut.ctypes.data_as(ctypes.c_void_p),
        len_lut.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p))
    if r < 0:
        from .errors import CorruptStreamError

        raise CorruptStreamError("Huffman payload overran its chunk")
    return out[:n]


def assemble_stream_native(kinds, values, ngroups, remaining_elems,
                           widths, hdrvals, dense, ndims, elem_sz,
                           lowdim, tail_bytes: bytes, wsums=None):
    """Native final stream assembly; returns bytes or None.

    ``wsums``: optional (nb,) int32 per-block width sums — the device
    encode pass computes them anyway; passing them skips the native
    O(nslots * ndims) resum (measured ~0.9 ms of a 2 ms assembly at
    d64 / 8 MiB)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "sprintz_assemble_stream"):
        return None
    kinds = np.ascontiguousarray(kinds, np.int8)
    values = np.ascontiguousarray(values, np.int32)
    widths = np.ascontiguousarray(widths, np.int32)
    hdrvals = np.ascontiguousarray(hdrvals, np.uint8)
    dense = np.ascontiguousarray(dense, np.uint8)
    maxb = dense.shape[-1]
    tail = np.frombuffer(tail_bytes, np.uint8)
    cap = (8 + dense.nbytes + kinds.size * (8 + (ndims + 1))
           + tail.nbytes + 4096)
    out = np.empty(cap, dtype=np.uint8)
    if wsums is not None:
        wsums = np.ascontiguousarray(wsums, np.int32)
    fn = lib.sprintz_assemble_stream
    fn.restype = ctypes.c_int64
    n = fn(kinds.ctypes.data_as(ctypes.c_void_p),
           values.ctypes.data_as(ctypes.c_void_p),
           ctypes.c_int64(kinds.size), ctypes.c_int64(ngroups),
           ctypes.c_int64(remaining_elems),
           widths.ctypes.data_as(ctypes.c_void_p),
           hdrvals.ctypes.data_as(ctypes.c_void_p),
           dense.ctypes.data_as(ctypes.c_void_p),
           ctypes.c_int64(maxb), ctypes.c_int32(ndims),
           ctypes.c_int32(elem_sz), ctypes.c_int32(int(lowdim)),
           tail.ctypes.data_as(ctypes.c_void_p),
           ctypes.c_int64(tail.nbytes),
           out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(cap),
           wsums.ctypes.data_as(ctypes.c_void_p) if wsums is not None
           else ctypes.c_void_p(0))
    if n < 0:
        return None
    return out[:n].tobytes()
