"""Canonical length-limited Huffman coding with chunk-parallel decode.

Fills the role of the paper's Huff0 stage (SprintzFIRE+Huf,
communicate/method.tex:300-303) with a chunk-parallel design:

- **Tables**: canonical codes from length-limited Huffman (max 12 bits,
  Kraft-repair length limiting). 256 x 4-bit lengths ship in a 128-byte
  table header — cheap to broadcast across chips.
- **Encode**: vectorized — per-symbol (code, length) LUTs, bit offsets by
  prefix sum, emission via LSB-first bit expansion + packbits. Symbols are
  grouped into independent chunks.
- **Decode**: chunk-parallel, lanes = chunks, a lax.scan advancing every
  chunk's bit cursor TWO symbols per step — the "serial Huffman becomes
  table-driven parallel decode" requirement of the north star. The device
  formulation is gather-free (it was written for a device whose per-lane
  indexed gathers were slow; a gather-based refill is the Hopper
  candidate of ROADMAP Queue 1 item 7):
    * refill: one branchless select-accumulate over the chunk's u32
      payload words per step (the only O(W) term, so decode cost scales
      with chunk_symbols — small chunks are the device sweet spot),
    * code length: bit-reverse the 12-bit peek and compare against the 11
      canonical level boundaries (no 4096-entry LUT),
    * symbol: the scan emits canonical symbol *indices*; the index ->
      symbol permutation runs afterwards in bulk as a bit-sliced
      truth-table lookup (fused elementwise ops on full-width arrays
      rather than one-hot matmuls with 16/256-wide minor dims).
  The native C++ loop serves host-only processes; a numpy fallback
  decodes chunk-vectorized.

Stream layout (this framework's own; the reference has no in-repo format):
  v2: [u32 n_symbols][u16 chunk_symbols][u16 flags][u32 nchunks]
      [128B lengths table][u16 (flags&2) or u32 payload_nbytes per chunk]
      [chunk payloads...]
  v1 (round 2, still read): [u32 n][u32 chunk_symbols][u32 nchunks]
      [128B lengths table][u32 sizes][payloads...]  — detected by
      flags == 0 (v1's chunk_symbols high half, always 0 below 65536).
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from .. import config

MAX_CODE_LEN = 12
# Symbols per chunk; each chunk costs a 2-byte size entry and restarts
# the bit cursor. 4096 on every stream: on the H100 machine the native
# host decode (the route huff_decompress("auto") takes) runs as fast at
# 4096 as at 128 from 4 to 64 MiB, and the stream is ~1.9% smaller
# (PERF.md). Small chunks only help a chunk-parallel device decode
# (more lanes, shorter scans); SPRINTZ_HUFF_CHUNK=128 picks them.
DEFAULT_CHUNK_SYMBOLS = config.get("SPRINTZ_HUFF_CHUNK")
_FLAG_V2 = 1
_FLAG_SIZES_U16 = 2
# stored (uncompressed) stream: 12-byte header + raw payload, chosen at
# encode time whenever Huffman coding does not win — the raw-chunk
# escape the paper's Huff0 has. +Huf must never lose ratio: sprintz
# output is often near-incompressible, and without the escape the
# table+sizes overhead made 18/20 mini-corpus cells worse.
_FLAG_STORED = 4
_STORED_HEAD_LEN = 12


@dataclasses.dataclass
class HuffmanTable:
    lengths: np.ndarray  # (256,) uint8, 0 = symbol absent
    codes: np.ndarray  # (256,) uint32, canonical, LSB-first bit order

    def decode_lut(self) -> tuple[np.ndarray, np.ndarray]:
        """(4096,) symbol and length tables indexed by the next 12 bits
        (LSB-first peek)."""
        sym = np.zeros(1 << MAX_CODE_LEN, dtype=np.uint8)
        ln = np.zeros(1 << MAX_CODE_LEN, dtype=np.uint8)
        for s in range(256):
            L = int(self.lengths[s])
            if L == 0:
                continue
            code = int(self.codes[s])
            step = 1 << L
            for fill in range(code, 1 << MAX_CODE_LEN, step):
                sym[fill] = s
                ln[fill] = L
        return sym, ln

    def canonical_tables(self):
        """Tables for the gather-free device decode.

        Returns (limits (11,), adj (13,), perm (256,)) int32:
        - the code length of a bit-reversed 12-bit peek v is
          ``1 + sum_l [v >= limits[l]]`` (limits[l] = left-justified
          first code of length l+2 — canonical levels partition the
          12-bit value space in order),
        - its canonical index is ``(v >> (12 - L)) + adj[L]``,
        - ``perm[index]`` is the symbol (indices enumerate symbols in
          (length, symbol) order — exactly _canonical_codes' order).
        """
        counts = np.bincount(self.lengths, minlength=MAX_CODE_LEN + 1)
        first = np.zeros(MAX_CODE_LEN + 2, dtype=np.int64)
        c = 0
        for ln in range(1, MAX_CODE_LEN + 2):
            first[ln] = c
            c = (c + (counts[ln] if ln <= MAX_CODE_LEN else 0)) << 1
        # left-justified level starts; level l+1's start is level l's end
        lj = np.zeros(MAX_CODE_LEN + 2, dtype=np.int64)
        for ln in range(1, MAX_CODE_LEN + 2):
            lj[ln] = first[ln] << max(MAX_CODE_LEN - ln, 0)
        limits = lj[2 : MAX_CODE_LEN + 1].astype(np.int32)  # (11,)
        # off[L] = number of symbols with shorter codes = cumsum through
        # L-1, excluding counts[0] (absent symbols)
        off = np.cumsum(counts)[:MAX_CODE_LEN] - counts[0]
        adj = np.zeros(MAX_CODE_LEN + 1, dtype=np.int64)
        adj[1:] = off - first[1 : MAX_CODE_LEN + 1]
        perm = np.zeros(256, dtype=np.int32)
        k = 0
        for ln in range(1, MAX_CODE_LEN + 1):
            for s in range(256):
                if self.lengths[s] == ln:
                    perm[k] = s
                    k += 1
        return limits, adj.astype(np.int32), perm


def _limited_lengths(counts: np.ndarray, max_len: int = MAX_CODE_LEN
                     ) -> np.ndarray:
    """Huffman code lengths, limited to max_len via Kraft repair."""
    syms = np.nonzero(counts)[0]
    lengths = np.zeros(256, dtype=np.uint8)
    if len(syms) == 0:
        return lengths
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths
    # standard Huffman on a heap of (count, tiebreak, node)
    heap = [(int(counts[s]), int(s), ("leaf", int(s))) for s in syms]
    heapq.heapify(heap)
    tb = 256
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        heapq.heappush(heap, (c1 + c2, tb, ("node", n1, n2)))
        tb += 1
    stack = [(heap[0][2], 0)]
    while stack:
        node, depth = stack.pop()
        if node[0] == "leaf":
            lengths[node[1]] = max(1, depth)
        else:
            stack.append((node[1], depth + 1))
            stack.append((node[2], depth + 1))
    # length-limit: clamp, then repair Kraft sum by extending the
    # shallowest-clamped codes
    over = lengths > max_len
    if over.any():
        lengths[over] = max_len
        kraft = np.sum((lengths > 0) * (1 << (max_len - lengths.astype(int))))
        while kraft > (1 << max_len):
            # deepen the least-frequent symbol not yet at max_len
            cands = np.nonzero((lengths > 0) & (lengths < max_len))[0]
            s = cands[np.argmin(counts[cands])]
            kraft -= 1 << (max_len - int(lengths[s]))
            lengths[s] += 1
            kraft += 1 << (max_len - int(lengths[s]))
        # tighten codes that can be shortened for free
        while True:
            kraft = np.sum((lengths > 0) * (1 << (max_len - lengths.astype(int))))
            slack = (1 << max_len) - kraft
            cands = np.nonzero(lengths > 1)[0]
            improved = False
            for s in cands[np.argsort(-counts[cands])]:
                gain = 1 << (max_len - int(lengths[s]))
                if gain <= slack:
                    lengths[s] -= 1
                    improved = True
                    break
            if not improved:
                break
    return lengths


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical code assignment, emitted LSB-first (bit-reversed)."""
    codes = np.zeros(256, dtype=np.uint32)
    code = 0
    prev_len = 0
    order = sorted((int(lengths[s]), s) for s in range(256) if lengths[s])
    for L, s in order:
        code <<= (L - prev_len)
        # bit-reverse to make the LSB-first peek index canonical
        rev = int(f"{code:0{L}b}"[::-1], 2)
        codes[s] = rev
        code += 1
        prev_len = L
    return codes


def build_table(data: np.ndarray | bytes) -> HuffmanTable:
    from ..native_host import histogram_native

    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    counts = histogram_native(arr)
    if counts is None:
        counts = np.bincount(arr, minlength=256)
    lengths = _limited_lengths(counts)
    return HuffmanTable(lengths=lengths, codes=_canonical_codes(lengths))


def _pack_table(t: HuffmanTable) -> bytes:
    nib = t.lengths.astype(np.uint8)
    return (nib[0::2] | (nib[1::2] << 4)).tobytes()  # 128 bytes


def _unpack_table(buf: bytes) -> HuffmanTable:
    nib = np.frombuffer(buf, dtype=np.uint8)
    lengths = np.zeros(256, dtype=np.uint8)
    lengths[0::2] = nib & 0xF
    lengths[1::2] = nib >> 4
    return HuffmanTable(lengths=lengths, codes=_canonical_codes(lengths))


def _build_head(n: int, chunk_symbols: int, nchunks: int, t: HuffmanTable,
                sizes: np.ndarray) -> bytes:
    """v2 stream header; sizes shrink to u16 whenever they fit.

    chunk_symbols must fit u16. Readback caveat: a hypothetical v1
    stream written with chunk_symbols >= 65536 would alias the v2 flags
    field (its high half is _parse's flags==0 discriminator); v1 writers
    in this repo never exceeded 4096, so detection is sound in practice.
    """
    if chunk_symbols >= (1 << 16):
        raise ValueError(
            f"chunk_symbols must fit in u16, got {chunk_symbols} "
            "(the v2 header stores it as u16)")
    u16_ok = sizes.size == 0 or int(sizes.max()) < (1 << 16)
    flags = _FLAG_V2 | (_FLAG_SIZES_U16 if u16_ok else 0)
    return (np.uint32(n).tobytes()
            + np.uint16(chunk_symbols).tobytes() + np.uint16(flags).tobytes()
            + np.uint32(nchunks).tobytes() + _pack_table(t)
            + sizes.astype(np.uint16 if u16_ok else np.uint32).tobytes())


def _stored_stream(arr: np.ndarray, chunk_symbols: int) -> bytes:
    return (np.uint32(arr.size).tobytes()
            + np.uint16(chunk_symbols).tobytes()
            + np.uint16(_FLAG_V2 | _FLAG_STORED).tobytes()
            + np.uint32(0).tobytes() + arr.tobytes())


def huff_compress(data: np.ndarray | bytes,
                  chunk_symbols: int | None = None,
                  table: HuffmanTable | None = None,
                  backend: str = "native",
                  allow_stored: bool = True) -> bytes:
    """Chunked canonical Huffman encode.

    backend "native" (default): the C++ emission loop (hundreds of
    MB/s — the role Huff0 plays for the reference paper), numpy
    fallback. backend "device": the byte-identical device encode pass
    (bitslice LUT + append scan) — worth it when the data is already near the device or host cores
    are the bottleneck; host keeps table build + ragged assembly.

    chunk_symbols None = DEFAULT_CHUNK_SYMBOLS. Whenever
    the coded stream would be no smaller than raw + 12 bytes the stream
    is STORED instead, so +Huf never loses more than 12 bytes to plain
    sprintz. allow_stored=False forces a coded container (benchmarks /
    A-B harnesses that feed device_decode_prep, which decodes coded
    containers only)."""
    from ..native_host import huff_encode_native

    arr0 = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    if chunk_symbols is None:
        chunk_symbols = DEFAULT_CHUNK_SYMBOLS
    if chunk_symbols >= (1 << 16):
        raise ValueError(
            f"chunk_symbols must fit in u16, got {chunk_symbols}")
    if backend == "device":
        out = huff_compress_device(data, chunk_symbols, table)
    else:
        out = _huff_compress_host(arr0, chunk_symbols, table)
    if (allow_stored and arr0.size
            and len(out) >= arr0.size + _STORED_HEAD_LEN):
        return _stored_stream(arr0, chunk_symbols)
    return out


def _huff_compress_host(arr, chunk_symbols, table):
    from ..native_host import huff_encode_native

    t = build_table(arr) if table is None else table
    n = arr.size

    native = huff_encode_native(arr, chunk_symbols, t.codes, t.lengths)
    if native is not None:
        payload, sizes = native
        return _build_head(n, chunk_symbols, sizes.size, t, sizes) + payload
    nchunks = max(1, -(-n // chunk_symbols))
    padded_n = nchunks * chunk_symbols
    lens = np.zeros(padded_n, dtype=np.int64)
    codes = np.zeros(padded_n, dtype=np.int64)
    lens[:n] = t.lengths[arr]
    codes[:n] = t.codes[arr]
    lens2 = lens.reshape(nchunks, chunk_symbols)
    offs = np.cumsum(lens2, axis=1) - lens2  # per-chunk bit offsets
    chunk_bits = offs[:, -1] + lens2[:, -1]
    max_bits = int(chunk_bits.max()) if n else 0
    width = ((max_bits + 7) // 8) * 8 + 8
    bits = np.zeros(nchunks * width, dtype=np.uint8)
    # flat 1-D targets; one vectorized pass per code-bit position (total
    # work is sum(lens), not nchunks*chunk_symbols*12)
    flat_base = (np.arange(nchunks, dtype=np.int64)[:, None] * width
                 + offs).reshape(-1)
    lens_flat = lens2.reshape(-1)
    maxlen = int(lens_flat.max()) if n else 0
    for k in range(maxlen):
        sel = np.nonzero(lens_flat > k)[0]
        bits[flat_base[sel] + k] = (codes[sel] >> k) & 1
    bits = bits.reshape(nchunks, width)
    packed = np.packbits(bits, axis=1, bitorder="little")
    sizes = ((chunk_bits + 7) // 8).astype(np.uint32)
    payloads = [packed[c, : sizes[c]].tobytes() for c in range(nchunks)]
    return (_build_head(n, chunk_symbols, nchunks, t, sizes)
            + b"".join(payloads))


def is_container(buf: bytes) -> bool:
    """Strict structural check: does ``buf`` parse as a huff_compress
    container (v1, v2, or stored) with an EXACT length match?

    This is the discriminator behind the zero-overhead stored escape at
    the codec level (api.py): when Huffman does not pay, SprintzCodec
    emits the plain sprintz stream verbatim, and decompress routes on
    this check. Encode guarantees determinism: a plain stream that
    would (astronomically rarely) satisfy this check is never emitted
    verbatim — the 12-byte stored wrapper is used instead — so decode
    never guesses.
    """
    if len(buf) < 12:
        return False
    n = int(np.frombuffer(buf, np.uint32, 1)[0])
    cs16, flags = (int(v) for v in np.frombuffer(buf, np.uint16, 2, offset=4))
    nchunks = int(np.frombuffer(buf, np.uint32, 1, offset=8)[0])
    if flags & _FLAG_STORED:
        return (flags == (_FLAG_V2 | _FLAG_STORED) and nchunks == 0
                and len(buf) == _STORED_HEAD_LEN + n)
    if flags == 0:  # v1: u32 chunk_symbols at 4, u32 sizes
        chunk_symbols, sz_itemsize = int(
            np.frombuffer(buf, np.uint32, 1, offset=4)[0]), 4
    elif flags & _FLAG_V2 and not flags & ~(_FLAG_V2 | _FLAG_SIZES_U16):
        chunk_symbols = cs16
        sz_itemsize = 2 if flags & _FLAG_SIZES_U16 else 4
    else:
        return False
    if chunk_symbols <= 0:
        return False
    if nchunks != -(-n // chunk_symbols) and not (n == 0 and nchunks <= 1):
        return False  # (the host encoder emits one empty chunk for n=0)
    payload_start = 140 + sz_itemsize * nchunks
    if len(buf) < payload_start:
        return False
    sizes = np.frombuffer(buf, np.uint16 if sz_itemsize == 2 else np.uint32,
                          nchunks, offset=140)
    if n and (sizes == 0).any():
        return False
    return len(buf) == payload_start + int(sizes.astype(np.int64).sum())


def _parse(buf: bytes):
    n = int(np.frombuffer(buf, dtype=np.uint32, count=1)[0])
    cs16, flags = np.frombuffer(buf, dtype=np.uint16, count=2, offset=4)
    if flags == 0:  # v1: u32 chunk_symbols, u32 sizes
        chunk_symbols = int(np.frombuffer(buf, np.uint32, 1, offset=4)[0])
        sz_dt = np.uint32
    else:
        chunk_symbols = int(cs16)
        sz_dt = np.uint16 if flags & _FLAG_SIZES_U16 else np.uint32
    nchunks = int(np.frombuffer(buf, dtype=np.uint32, count=1, offset=8)[0])
    t = _unpack_table(buf[12 : 12 + 128])
    sizes = np.frombuffer(buf, dtype=sz_dt, count=nchunks, offset=140)
    payload_start = 140 + sizes.itemsize * nchunks
    offsets = payload_start + np.concatenate(
        [[0], np.cumsum(sizes.astype(np.int64))])[:-1]
    return n, chunk_symbols, nchunks, t, sizes, offsets


def huff_decompress(buf: bytes, backend: str = "auto") -> np.ndarray:
    """Decode a huff_compress stream.

    backend: "auto" and "native" run the native C++ table-driven loop
    (where the reference runs Huff0), or the numpy decode when the
    native library is off (SPRINTZ_NO_NATIVE); "jax" runs the
    chunk-parallel device decode (the XLA scan of _make_decode_device);
    "numpy" the vectorized host decode. "auto" never picks the device:
    on the H100 the device decode lost to the native loop at every size
    up to 64 MiB of symbols (PERF.md). A failure of the device decode
    propagates.
    """
    flags = int(np.frombuffer(buf, np.uint16, 1, offset=6)[0])
    if flags & _FLAG_STORED:
        n = int(np.frombuffer(buf, np.uint32, 1)[0])
        return np.frombuffer(buf, np.uint8, n,
                             offset=_STORED_HEAD_LEN).copy()
    n, chunk_symbols, nchunks, t, sizes, offsets = _parse(buf)
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    if backend == "jax":
        return _decode_jax(buf, n, chunk_symbols, nchunks, t, sizes,
                           offsets)
    if backend in ("auto", "native"):
        from ..native_host import huff_decode_native

        sym_lut, len_lut = t.decode_lut()
        native = huff_decode_native(buf, offsets, sizes, chunk_symbols, n,
                                    sym_lut, len_lut)
        if native is not None:
            return native
    return _decode_np(buf, n, chunk_symbols, nchunks, t, sizes, offsets)


def _dense_payloads(data: np.ndarray, offsets, sizes, maxb: int,
                    nc_pad: int | None = None) -> np.ndarray:
    """Gather chunk payloads into a rectangular (nchunks, maxb) u8 buffer
    (vectorized — no per-chunk Python loop; chunk counts reach 1e5+)."""
    nchunks = len(sizes)
    dense = np.zeros((nc_pad or nchunks, maxb), dtype=np.uint8)
    ln = sizes.astype(np.int64)
    tot = int(ln.sum())
    if tot:
        starts = np.cumsum(ln) - ln
        q = np.arange(tot, dtype=np.int64) - np.repeat(starts, ln)
        flat = dense.reshape(-1)
        flat[np.repeat(np.arange(nchunks, dtype=np.int64) * maxb, ln) + q] \
            = data[np.repeat(offsets.astype(np.int64), ln) + q]
    return dense


def _decode_np(buf, n, chunk_symbols, nchunks, t, sizes, offsets):
    """Chunk-vectorized decode: all chunks advance one symbol per step."""
    sym_lut, len_lut = t.decode_lut()
    data = np.frombuffer(buf, dtype=np.uint8)
    maxb = int(sizes.max()) + 4 if nchunks else 4
    dense = _dense_payloads(data, offsets, sizes, maxb).astype(np.int64)
    rows = np.arange(nchunks)
    bitpos = np.zeros(nchunks, dtype=np.int64)
    syms = np.empty((nchunks, chunk_symbols), dtype=np.uint8)
    sym_lut_i = sym_lut.astype(np.uint8)
    len_lut_i = len_lut.astype(np.int64)
    for i in range(chunk_symbols):
        # clamp: the final chunk keeps stepping past its own payload
        byte = np.minimum(bitpos >> 3, maxb - 3)
        w = (dense[rows, byte] | (dense[rows, byte + 1] << 8)
             | (dense[rows, byte + 2] << 16))
        peek = (w >> (bitpos & 7)) & 0xFFF
        syms[:, i] = sym_lut_i[peek]
        bitpos += len_lut_i[peek]
    return syms.reshape(-1)[:n]


def device_decode_prep(buf: bytes):
    """Host prep for the device decode: returns
    (words (nc_pad, W32) uint32, tables (limits, adj, perm) int32,
     chunk_symbols, nchunks, n). Shapes are bucketed for jit reuse."""
    from ..utils.shapes import next_bucket

    data = np.frombuffer(buf, dtype=np.uint8)
    if int(np.frombuffer(buf, np.uint16, 1, offset=6)[0]) & _FLAG_STORED:
        raise ValueError("stored huff container has no device decode; "
                         "read it with huff_decompress "
                         "(or encode with allow_stored=False)")
    n, chunk_symbols, nchunks, t, sizes, offsets = _parse(buf)
    maxb = int(sizes.max()) if nchunks else 0
    # u32 words, one spare so the refill select never matches past the end
    w32 = -(-max(maxb, 1) // 4) + 1
    w32 += (-w32) % 8  # mult-of-8 bucket: jit reuse without pow2 blowup
    nc_pad = next_bucket(max(nchunks, 1), minimum=8)
    dense = _dense_payloads(data, offsets, sizes, w32 * 4, nc_pad=nc_pad)
    # (W, C) layout: every (., C) slice in the kernel is full-lane minor
    # (a (C, W<=136)-minor layout pads each row to 128 lanes)
    words = np.ascontiguousarray(
        dense.reshape(nc_pad, w32, 4).view(np.uint32)[..., 0].T)
    limits, adj, perm = t.canonical_tables()
    perm_b = pack_byte_lut(perm)
    return words, (limits, adj, perm_b), chunk_symbols, nchunks, n


def _decode_jax(buf, n, chunk_symbols, nchunks, t, sizes, offsets):
    """Chunk-parallel device decode: lanes = chunks, 2 symbols per step
    (the XLA scan of ``_make_decode_device``)."""
    words, tables, cs, nchunks, n = device_decode_prep(buf)
    import jax.numpy as jnp

    out = get_decode_device()(
        jnp.asarray(words), *(jnp.asarray(x) for x in tables), cs)
    return np.asarray(out[:nchunks]).reshape(-1)[:n].astype(np.uint8)


def _rev12(x):
    """Bit-reverse the low 12 bits (uint32 lanes, 4 swap rounds)."""
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> 4


def pack_truth_tables(values: np.ndarray, nbits: int) -> np.ndarray:
    """(256,)-entry lookup table -> (nbits, 8) uint32 bit-sliced truth
    tables for _bitslice_lookup: bit k of values[i] lives at bit (i & 31)
    of word [k, i >> 5]."""
    t = np.zeros((nbits, 8), dtype=np.uint32)
    v = values.astype(np.int64)
    for k in range(nbits):
        bits = (v >> k) & 1
        t[k] = np.packbits(
            bits.astype(np.uint8).reshape(8, 32), axis=1,
            bitorder="little").view(np.uint32)[:, 0]
    return t


def pack_byte_lut(values: np.ndarray) -> np.ndarray:
    """(256,) byte table -> (64,) uint32, 4 bytes per word little-endian,
    for _byte_lookup."""
    return np.ascontiguousarray(
        values.astype(np.uint8)).view(np.uint32).copy()


def _byte_lookup(idx, words64):
    """256-entry BYTE table lookup as a flat 63-deep select.

    Any 256-byte LUT is 64 u32 words; selecting the word by idx >> 2
    (63 wheres) and extracting the byte by (idx & 3) * 8 costs ~66
    elementwise ops — 1.35x fewer than the 8-output-bit truth-table
    route (_bitslice_lookup: 8 x (7-select + shift/mask) ~ 88 ops),
    which pays the word-select once PER OUTPUT BIT. Same no-gather,
    no-small-minor-one-hot design.
    idx: int32 in [0, 256); words64: (64,) uint32.
    """
    import jax.numpy as jnp

    wsel = idx >> 2
    w = jnp.broadcast_to(words64[0], idx.shape)
    for j in range(1, 64):
        w = jnp.where(wsel == j, words64[j], w)
    return ((w >> ((idx & 3) * 8).astype(jnp.uint32)) & 255).astype(
        jnp.int32)


def _bitslice_lookup(idx, tables, nbits: int):
    """Arbitrary 256-entry table lookup as pure elementwise ops.

    One-hot matmul lookups materialize (N, 16..256) one-hots whose tiny
    minor dims pad under a 128-lane tiling. Instead each OUTPUT BIT is a 256-bit
    truth table in 8 u32 words: select the word with a 7-deep where
    chain on idx>>5, shift by idx&31 — ~12 fused elementwise ops per
    output bit, any shape, no padding. idx: int32 in [0, 256);
    tables: (nbits, 8) uint32.
    """
    import jax.numpy as jnp

    wsel = idx >> 5
    sh = (idx & 31).astype(jnp.uint32)
    out = jnp.zeros(idx.shape, jnp.int32)
    for k in range(nbits):
        w = jnp.broadcast_to(tables[k, 0], idx.shape)
        for j in range(1, 8):
            w = jnp.where(wsel == j, tables[k, j], w)
        out = out | (((w >> sh) & 1) << k).astype(jnp.int32)
    return out


def _make_decode_device():
    import functools

    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("chunk_symbols",))
    def decode_device(words, limits, adj, perm_b, chunk_symbols):
        """Gather-free chunk-parallel canonical Huffman decode.

        words: (W, C) uint32 little-endian payload words per chunk
        (lane-major: every slice the kernel touches has the huge C axis
        minor); limits/adj: canonical_tables();
        perm_b: pack_byte_lut(perm). Returns (C, chunk_symbols)
        uint8 symbols (junk past each chunk's true payload — callers
        slice). Every op is elementwise/reduce on full-minor arrays: no
        per-lane indexed gathers, no small-minor one-hots. lax.scan
        steps = symbols/2.
        """
        W, C = words.shape
        steps = (chunk_symbols + 1) // 2

        def decode1(lo, hi, nbits):
            v = _rev12(lo & 0xFFF).astype(jnp.int32)
            L = jnp.ones_like(nbits)
            for i in range(MAX_CODE_LEN - 1):
                L = L + (v >= limits[i]).astype(jnp.int32)
            a = jnp.zeros_like(L)
            for li in range(1, MAX_CODE_LEN + 1):
                a = a + jnp.where(L == li, adj[li], 0)
            idx = jax.lax.shift_right_logical(
                v, MAX_CODE_LEN - L) + a
            idx = jnp.clip(idx, 0, 255)  # junk peeks stay in range
            Lu = L.astype(jnp.uint32)
            lo = (lo >> Lu) | (hi << (32 - Lu))  # 1 <= L <= 12
            hi = hi >> Lu
            return lo, hi, nbits - L, idx

        def step(carry, _):
            lo, hi, nbits, widx = carry
            # branchless refill: ONE u32 per step keeps >= 24 bits
            # banked before decoding two <= 12-bit symbols. The select
            # chain over the static W words replaces a per-lane gather.
            need = nbits < 24
            w = jnp.zeros(C, jnp.uint32)
            for wi in range(W):
                w = jnp.where(widx == wi, words[wi], w)
            nb_u = nbits.astype(jnp.uint32)
            lo = jnp.where(need, lo | (w << nb_u), lo)
            # (w >> 1) >> (31 - nbits) == w >> (32 - nbits), and stays
            # defined at nbits == 0 (plain 32-shift would be UB)
            hi = jnp.where(need, hi | ((w >> 1) >> (31 - nb_u)), hi)
            nbits = nbits + jnp.where(need, 32, 0)
            widx = widx + need.astype(jnp.int32)
            lo, hi, nbits, i0 = decode1(lo, hi, nbits)
            lo, hi, nbits, i1 = decode1(lo, hi, nbits)
            return (lo, hi, nbits, widx), i0 | (i1 << 8)

        zero_u = jnp.zeros(C, jnp.uint32)
        zero_i = jnp.zeros(C, jnp.int32)
        _, packed = jax.lax.scan(
            step, (zero_u, zero_u, zero_i, zero_i), None, length=steps)
        p = packed.T  # (C, steps)
        idx = jnp.stack([p & 255, (p >> 8) & 255], -1).reshape(
            C, 2 * steps)[:, :chunk_symbols]
        # canonical index -> symbol: flat-select byte-LUT lookup
        # (fused elementwise, full tiles; the nibble one-hot matmul
        # measured 8x minor-dim padding bloat on device)
        sym = _byte_lookup(idx, perm_b)
        return sym.astype(jnp.uint8)

    return decode_device


_decode_device_fn = None


def get_decode_device():
    """The jitted device decode kernel (built lazily: jax optional)."""
    global _decode_device_fn
    if _decode_device_fn is None:
        _decode_device_fn = _make_decode_device()
    return _decode_device_fn


# ----------------------------------------------------------------- encode


def _make_encode_device():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def encode_device(syms, lut_tt):
        """Device Huffman encode pass: lanes = chunks.

        syms: (C, cs) int32 symbols (pad value 256 -> zero-length code);
        lut_tt: pack_truth_tables(codes | lengths << 12, 16). Returns
        (words (steps, C) int32 = u16 payload word | valid << 16,
         acc (C,) int32 final partial word, nbits (C,) int32 its bits).

        Per-symbol (code, len) comes from the bit-sliced truth-table
        lookup (fused elementwise, full tiles, and exact — the earlier
        one-hot matmul against an f32 table downcast to bf16 inside the
        MXU dot on device, corrupting codes > 8 significant bits); the
        append scan then emits one little-endian u16 word whenever 16
        bits accumulate — byte-identical LSB-first emission to the
        native C++ loop.
        """
        C, cs = syms.shape
        syms = syms.astype(jnp.int32)  # accepts narrow u16 params
        packed = jnp.where(
            syms > 255, 0, _bitslice_lookup(syms & 255, lut_tt, 16))

        def append1(acc, nbits, p):
            code = (p & 0xFFF).astype(jnp.uint32)
            ln = p >> 12
            acc = acc | (code << nbits.astype(jnp.uint32))  # <= 28 bits
            nbits = nbits + ln
            flush = nbits >= 16
            word = (acc & 0xFFFF).astype(jnp.int32)
            acc = jnp.where(flush, acc >> 16, acc)
            nbits = jnp.where(flush, nbits - 16, nbits)
            return acc, nbits, word | (flush.astype(jnp.int32) << 16)

        z = (jnp.zeros(C, jnp.uint32), jnp.zeros(C, jnp.int32))
        # symbols per scan step: 4 was the optimum of an earlier device
        # sweep over 1/2/4/8 (longer in-step serial append chains lose);
        # not re-measured on the H100.
        group = next((g for g in (4, 2) if cs % g == 0), 1)
        if group > 1:
            # several symbols per scan step (the decode kernel's trick)
            # amortize the scan's per-step overhead. Each append still flushes <= 1 u16 (acc < 16 bits
            # entering, len <= 12), so the stacked words keep the exact
            # word-order contract of the 1-sym scan.
            xs = packed.T.reshape(cs // group, group, C)

            def stepg(carry, pg):
                acc, nbits = carry
                ws = []
                for g in range(group):
                    acc, nbits, w = append1(acc, nbits, pg[g])
                    ws.append(w)
                return (acc, nbits), jnp.stack(ws)

            (acc, nbits), words = jax.lax.scan(stepg, z, xs)
            return words.reshape(cs, C), acc.astype(jnp.int32), nbits

        def step(carry, p):
            acc, nbits = carry
            acc, nbits, word = append1(acc, nbits, p)
            return (acc, nbits), word

        (acc, nbits), words = jax.lax.scan(step, z, packed.T)
        return words, acc.astype(jnp.int32), nbits

    return encode_device


_encode_device_fn = None


def get_encode_device():
    global _encode_device_fn
    if _encode_device_fn is None:
        _encode_device_fn = _make_encode_device()
    return _encode_device_fn


def encode_lut_packed(t: HuffmanTable) -> np.ndarray:
    """(16, 8) uint32 truth-table LUT (code | len << 12, 16 bits) for
    encode_device."""
    packed = t.codes.astype(np.int64) | (t.lengths.astype(np.int64) << 12)
    return pack_truth_tables(packed, 16)


def huff_compress_device(data: np.ndarray | bytes,
                         chunk_symbols: int = DEFAULT_CHUNK_SYMBOLS,
                         table: HuffmanTable | None = None) -> bytes:
    """huff_compress twin whose per-symbol emission runs on device
    (byte-identical output). Host keeps table build (native histogram)
    and the final ragged byte assembly, mirroring how the sprintz
    encoder splits device pass / host plan+assembly (encoder.py)."""
    import jax.numpy as jnp

    from ..utils.shapes import next_bucket

    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    t = build_table(arr) if table is None else table
    n = arr.size
    nchunks = max(1, -(-n // chunk_symbols))
    nc_pad = next_bucket(nchunks, 8)
    # u16 symbols (values <= 256): half the param bytes of i32, widened
    # in-kernel — the same narrow-param lever as the sprintz passes
    syms = np.full((nc_pad, chunk_symbols), 256, dtype=np.uint16)
    syms.reshape(-1)[:n] = arr
    words, acc, nbits = get_encode_device()(
        jnp.asarray(syms), jnp.asarray(encode_lut_packed(t)))
    return _assemble_device_encode(
        np.asarray(words), np.asarray(acc), np.asarray(nbits),
        n, chunk_symbols, nchunks, t)


def _assemble_device_encode(words, acc, nbits, n, chunk_symbols, nchunks,
                            t) -> bytes:
    """Host assembly of encode_device output (vectorized numpy)."""
    wt = words.T[:nchunks]  # (nchunks, steps)
    valid = (wt >> 16).astype(bool)
    nwords = valid.sum(axis=1).astype(np.int64)
    tail_bytes = (nbits[:nchunks].astype(np.int64) + 7) // 8
    sizes = (2 * nwords + tail_bytes).astype(np.uint32)
    bounds = np.cumsum(sizes.astype(np.int64))
    payload = np.zeros(int(bounds[-1]) if nchunks else 0, dtype=np.uint8)
    # u16 words, little-endian, compacted per chunk
    flat_w = wt[valid].astype(np.uint16)  # row-major: chunk order kept
    starts = bounds - sizes
    if flat_w.size:
        wstarts = np.repeat(starts, nwords)
        within = np.arange(flat_w.size) - np.repeat(
            np.cumsum(nwords) - nwords, nwords)
        payload[wstarts + 2 * within] = flat_w & 0xFF
        payload[wstarts + 2 * within + 1] = flat_w >> 8
    one = tail_bytes >= 1
    payload[(starts + 2 * nwords)[one]] = acc[:nchunks][one] & 0xFF
    two = tail_bytes == 2
    payload[(starts + 2 * nwords + 1)[two]] = (acc[:nchunks][two] >> 8) & 0xFF
    return (_build_head(n, chunk_symbols, nchunks, t, sizes)
            + payload.tobytes())
