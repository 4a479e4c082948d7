"""JAX bit-packing kernels: per-block payload bytes from errors + widths.

The reference packs with per-stripe ``_pext_u64`` loops
(sprintz_delta_rle.cpp:345-381). Here byte (un)packing is written as
**exact bf16 one-hot matmuls**, a formulation chosen for a device whose
per-element gathers and lane-dynamic shifts were slow; shift-based
formulations (``UNPACK_WLAYOUT=wordsel``, ``LOWDIM_IMPL=dyn``) sit beside
it for the H100 A/B (ROADMAP Queue 1 item 4):

- Every value contributes up to 3 bytes (w <= 16 bits shifted by <= 7).
- pack: dense[b,r,m] = sum_k sum_d [q_d+k == m] * c_k[b,r,d]
  — per byte-lane one-hot matmuls. Bits of different values never collide
  within a byte, so the adds equal the reference's ORs.
- unpack: word[b,r,d] = sum_j dense[b,r,j] * W[b,d,j],
  W in {0, 1, 256, 65536} selecting each dim's 3-byte window.

Exactness: bytes (<=255) and the weights (powers of two) are exact in
bf16; every product and sum stays < 2^24, so f32 accumulation is exact
integer arithmetic (TF32 never applies: the operands are bf16). Work is
chunked over blocks to bound the one-hot intermediates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..constants import BLOCK_SZ

# blocks per one-hot chunk: bounds the transient weight tensors.
_CHUNK = 16384

# Paired-dim unpack (u8 rowmajor only): one matmul window per dim PAIR
# — halves the (c, MAXB, D) unpack weight tensor. Exact because u8 pairs
# fit the 3-byte window ((off&7) + w0 + w1 <= 23 bits) and the pair word
# tops at 2^24 - 1 (f32-exact). Decoder call sites gate on elem_sz == 1.
UNPACK_PAIR = config.get("SPRINTZ_UNPACK_PAIR") == "1"

# Number format for the exact-matmul kernels: "bf16" (one matmul,
# weights in {1,256,65536}) or "s8" (s8*s8->s32 — half the weight
# bytes; bytes are biased into [-128,127] and debiased after, still
# exact integer arithmetic) or "bf3" (the shifted-payload formulation:
# ONE byte-select {0,1} one-hot — a single compare instead of the
# 3-level where chain — with byte-shifted payload copies riding the
# same dot; chunk_s8's structure with bf16 carriers).
# NOTE: flag is read at TRACE time — call jax.clear_caches() after
# changing it in-process.
MXU_IMPL = config.get("SPRINTZ_MXU_IMPL")

# Byte-window count for the rowmajor (un)pack matmuls: "auto" derives it
# from the element size — u8 fields never reach a third byte
# ((off & 7) + width <= 7 + 8 = 15 bits), so u8 streams build/apply TWO
# windows instead of three (one less compare+select level over the
# (c, MAXB, D) weight and one less pack matmul); u16 keeps 3 (<= 23
# bits). "3" forces the conservative pre-round-5 behavior for A/B.
UNPACK_NWIN = config.get("SPRINTZ_UNPACK_NWIN")


def _nwin(elem_sz: int) -> int:
    if UNPACK_NWIN == "3":
        return 3
    # 2 windows are only ever valid for u8 fields ((off & 7) + width
    # <= 15 bits); a forced "2" on a u16 stream would silently emit
    # corrupt bytes, so the override clamps to u8 call sites.
    return 2 if elem_sz == 1 else 3

# Lowdim (column-major) kernel formulation. "select" is a pure int32
# select-accumulate laid out with the BLOCK axis minor, built for the
# lane-starved D <= 4 batched matmuls; the simpler "einsum" matmul path
# is the default and select is the A/B alternate. "wselect" is the width-stratified formulation: per legal
# width the field layout is fully static (lowdim bit offsets are r*w,
# no cross-dim cumsum), so pack/unpack become static shifts + one
# select per width — ~6x fewer element-ops than either other path.
LOWDIM_IMPL = config.get("SPRINTZ_LOWDIM_IMPL")

# d3 grouped fold (see decoder.LOWDIM_D3 — both modules read the same
# knob so the (un)pack twins agree with the fused passes).
LOWDIM_D3 = config.get("SPRINTZ_LOWDIM_D3")

# Rowmajor unpack formulation: "auto" = wordsel (matmul-free u32 word
# select + funnel shift) when maxb == 8, where its select chain is 2
# deep, and one-hot matmul ("transpose") otherwise. "dot" builds the
# weight in the dot-operand layout.
UNPACK_WLAYOUT = config.get("SPRINTZ_UNPACK_WLAYOUT")


def _wordsel_ok(maxb: int) -> bool:
    if UNPACK_WLAYOUT == "wordsel":
        return maxb % 4 == 0
    return UNPACK_WLAYOUT == "auto" and maxb == 8


def _lowdim_widths(eb: int):
    """Non-zero legal lowdim widths: 1..eb minus eb-1 (bitmath
    block_widths_lowdim promotes eb-1 to eb)."""
    return [w for w in range(1, eb + 1) if w != eb - 1]


def _chunked(fn, n_leading: int, *arrays, chunk: int | None = None):
    """Apply fn over equal chunks of the leading axis and concatenate.

    Chunking bounds the transient one-hot weight tensors to ~_CHUNK
    blocks. The chunk size adapts to n_leading (ceil(n/ceil(n/_CHUNK)),
    rounded to a multiple of 8) so ragged inputs pad by at most
    nchunks*8 rows instead of up to a whole chunk — the grouped lowdim
    passes produce c = ceil(nb/G), which is never chunk-aligned for
    non-pow2 streams. Zero pad rows (width 0) pack/unpack to zeros and
    are sliced back off. ``chunk`` overrides _CHUNK (the xff serial
    pass keeps 8192: the single 16384 unpack chunk serializes ahead of
    the FIRE scan)."""
    _chunk = chunk or _CHUNK
    if n_leading <= _chunk:
        return fn(*arrays)
    nchunks = -(-n_leading // _chunk)
    chunk = -(-n_leading // nchunks)
    chunk += (-chunk) % 8
    pad = nchunks * chunk - n_leading
    if pad:
        arrays = tuple(
            jnp.concatenate(
                [a, jnp.zeros((pad, *a.shape[1:]), a.dtype)]) for a in arrays)
    reshaped = [a.reshape(nchunks, chunk, *a.shape[1:]) for a in arrays]
    out = jax.lax.map(lambda args: fn(*args), tuple(reshaped))
    out = out.reshape(nchunks * chunk, *out.shape[2:])
    return out[:n_leading] if pad else out


def _matmul_exact(a_bytes: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Batched (..., R, K) x (..., K, M) int matmul via exact bf16 MXU dot."""
    return jax.lax.dot_general(
        a_bytes.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
        dimension_numbers=(((a_bytes.ndim - 1,), (w.ndim - 2,)),
                           (tuple(range(a_bytes.ndim - 2)),
                            tuple(range(w.ndim - 2)))),
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)


def pack_rows_rowmajor(errs_zz: jnp.ndarray, widths: jnp.ndarray,
                       elem_sz: int, pair: bool = False) -> jnp.ndarray:
    """Pack row-major block payloads.

    errs_zz: (nb, 8, D) int32 zigzag errors; widths: (nb, D) int32.
    Returns dense (nb, 8, MAXB) uint8, MAXB = D * elem_sz; row r of block b
    occupies its first ceil(sum(widths[b])/8) bytes. ``pair``: paired-dim
    windows (halved one-hots; valid only when every width <= 8).
    """
    nb, _, ndims = errs_zz.shape
    maxb = ndims * elem_sz
    m = jnp.arange(maxb)

    def chunk(errs_c, widths_c):
        off = jnp.cumsum(widths_c, axis=1) - widths_c  # (c, D)
        c = errs_c << (off & 7)[:, None, :]  # up to 23 bits
        q = off >> 3
        out = jnp.zeros((errs_c.shape[0], BLOCK_SZ, maxb), jnp.float32)
        # u8 shifted fields stop at 15 bits, so byte 2 is always zero
        # and its one-hot + matmul are skipped (_nwin); byte-identical.
        for k in range(_nwin(elem_sz)):
            onehot = (q[:, :, None] + k == m[None, None, :])
            byte_k = (c >> (8 * k)) & 0xFF
            out = out + _matmul_exact(byte_k, onehot).astype(jnp.float32)
        return out.astype(jnp.uint8)

    def chunk_s8(errs_c, widths_c):
        # Single {0,1} int8 one-hot scatters each dim's FIRST byte; the
        # 2nd/3rd bytes ride the same weights as extra row groups, their
        # results shifted along the byte axis afterwards. Bias: several
        # dims may land on one byte (small widths share bytes), so the
        # debias is 128 * colsum(onehot) per output byte, per k.
        off = jnp.cumsum(widths_c, axis=1) - widths_c
        c = errs_c << (off & 7)[:, None, :]
        q = off >> 3
        onehot = (q[:, :, None] == m[None, None, :]).astype(jnp.int8)
        colsum = onehot.astype(jnp.int32).sum(axis=1)  # (c, MAXB)
        b3 = jnp.concatenate(
            [((c >> (8 * k)) & 0xFF) - 128 for k in range(3)],
            axis=1).astype(jnp.int8)  # (c, 24, D)
        p = jax.lax.dot_general(
            b3, onehot,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32)  # (c, 24, MAXB)
        p = p + (128 * colsum)[:, None, :]
        out = (p[:, :BLOCK_SZ]
               + jnp.roll(p[:, BLOCK_SZ: 2 * BLOCK_SZ], 1, axis=2)
                 .at[:, :, 0].set(0)
               + jnp.roll(p[:, 2 * BLOCK_SZ:], 2, axis=2)
                 .at[:, :, :2].set(0))
        return out.astype(jnp.uint8)

    def chunk_pair(errs_c, widths_c):
        # Paired-dim packing twin of the unpack chunk_pair: the pair's
        # combined field (e0 | e1 << w0) << (off & 7) still fits 3
        # bytes for u8 widths, so the per-byte-lane one-hots shrink to
        # (c, D/2, MAXB). Adds remain OR-equivalent: all fields are
        # bit-disjoint regardless of pairing.
        c0 = errs_c.shape[0]
        dp = ndims + (ndims & 1)
        wp = widths_c.astype(jnp.int32)
        ep = errs_c
        if dp != ndims:
            wp = jnp.concatenate(
                [wp, jnp.zeros((c0, 1), wp.dtype)], axis=1)
            ep = jnp.concatenate(
                [ep, jnp.zeros((c0, BLOCK_SZ, 1), ep.dtype)], axis=2)
        off = jnp.cumsum(wp, axis=1) - wp
        offp = off[:, 0::2]  # (c, Dp/2)
        w0 = wp[:, 0::2][:, None, :]
        cp = (ep[:, :, 0::2] | (ep[:, :, 1::2] << w0)
              ) << (offp & 7)[:, None, :]  # <= 23 bits
        q = offp >> 3
        out = jnp.zeros((c0, BLOCK_SZ, maxb), jnp.float32)
        for k in range(3):
            onehot = (q[:, :, None] + k == m[None, None, :])
            byte_k = (cp >> (8 * k)) & 0xFF
            out = out + _matmul_exact(byte_k, onehot).astype(jnp.float32)
        return out.astype(jnp.uint8)

    if pair:
        return _chunked(chunk_pair, nb, errs_zz, widths)
    return _chunked(chunk_s8 if MXU_IMPL == "s8" else chunk,
                    nb, errs_zz, widths)


def pack_dims_lowdim(errs_zz: jnp.ndarray, widths: jnp.ndarray,
                     elem_sz: int) -> jnp.ndarray:
    """Pack lowdim (column-major) block payloads.

    Each dim's 8 samples pack into exactly widths[b, d] bytes.
    Returns dense (nb, D, EB) uint8, EB = 8 * elem_sz.
    """
    nb, _, ndims = errs_zz.shape
    eb = 8 * elem_sz
    m = jnp.arange(eb)

    def chunk(errs_c, widths_c):
        cb = errs_c.shape[0]
        bitoff = jnp.arange(BLOCK_SZ)[None, :, None] * widths_c[:, None, :]
        c = errs_c << (bitoff & 7)  # (c, 8, D)
        q = bitoff >> 3
        # batch over (block, dim): values axis = the 8 samples
        c_t = c.transpose(0, 2, 1).reshape(cb * ndims, 1, BLOCK_SZ)
        q_t = q.transpose(0, 2, 1).reshape(cb * ndims, BLOCK_SZ)
        out = jnp.zeros((cb * ndims, 1, eb), jnp.float32)
        for k in range(3):
            onehot = (q_t[:, :, None] + k == m[None, None, :])
            byte_k = (c_t >> (8 * k)) & 0xFF
            out = out + _matmul_exact(byte_k, onehot).astype(jnp.float32)
        return out.astype(jnp.uint8).reshape(cb, ndims, eb)

    def chunk_sel(errs_c, widths_c):
        # VPU select-accumulate, block axis minor (lanes = blocks): each
        # output byte m of dim d collects the shifted sample bytes whose
        # landing byte q is m, m-1 or m-2. Bits of different samples
        # never collide within a byte, so the adds equal the ORs.
        w_t = widths_c.T  # (D, c)
        bitoff = jnp.arange(BLOCK_SZ)[:, None, None] * w_t[None]  # (8,D,c)
        c_t = errs_c.transpose(1, 2, 0) << (bitoff & 7)  # (8, D, c)
        q = bitoff >> 3
        rel = m[None, :, None, None] - q[:, None]  # (8, EB, D, c)
        b = c_t[:, None]  # (8, 1, D, c)
        out = jnp.sum(jnp.where(rel == 0, b & 0xFF, 0)
                      + jnp.where(rel == 1, (b >> 8) & 0xFF, 0)
                      + jnp.where(rel == 2, (b >> 16) & 0xFF, 0),
                      axis=0)  # (EB, D, c)
        return out.transpose(2, 1, 0).astype(jnp.uint8)  # (c, D, EB)

    def chunk_jpack(errs_c, widths_c):
        # Fused-select pack twin of the unpack's chunk_jsel: byte j of
        # a dim's field collects row fragments whose landing byte q_r
        # is j (low), j-1 (mid) or j-2 (high, eb=16 only). Bits of
        # different rows never collide within a byte, so the sum over
        # the 8-row axis equals the OR. All N-scale tensors stay
        # (c, 8, D) full-lane; shifts are static.
        bitoff = jnp.arange(BLOCK_SZ)[None, :, None] * widths_c[:, None, :]
        cshift = errs_c << (bitoff & 7)  # (c, 8, D) <= eb+7 bits
        q = bitoff >> 3
        byts = []
        for jbyte in range(eb):
            b = jnp.where(q == jbyte, cshift & 0xFF, 0)
            b = b | jnp.where(q == jbyte - 1, (cshift >> 8) & 0xFF, 0)
            if eb > 8:
                b = b | jnp.where(q == jbyte - 2, (cshift >> 16) & 0xFF, 0)
            byts.append(jnp.sum(b, axis=1))  # (c, D)
        return jnp.stack(byts, axis=-1).astype(jnp.uint8)  # (c, D, EB)

    def chunk_wpack(errs_c, widths_c):
        # Width-stratified: a lowdim dim's field layout depends ONLY on
        # its own width (bit offset of sample r is r*w — no cross-dim
        # cumsum, unlike rowmajor), and only |{0..eb} \ {eb-1}| widths
        # are legal. So emit each width's w-byte field with fully STATIC
        # shifts/ORs and combine with one select per width — no one-hot
        # matmul, no EB-wide select-accumulate.
        w_t = widths_c.T  # (D, c)
        e_t = errs_c.transpose(1, 2, 0)  # (8, D, c)
        out = jnp.zeros((eb, ndims, errs_c.shape[0]), jnp.int32)
        for w in _lowdim_widths(eb):
            byts = []
            for jbyte in range(w):
                acc = None
                for r in range(BLOCK_SZ):
                    br = r * w
                    if br + w <= 8 * jbyte or br >= 8 * (jbyte + 1):
                        continue
                    sh = br - 8 * jbyte
                    term = e_t[r] << sh if sh >= 0 else e_t[r] >> -sh
                    acc = term if acc is None else acc | term
                byts.append(acc & 0xFF)
            field = jnp.stack(
                byts + [jnp.zeros_like(byts[0])] * (eb - w))  # (EB, D, c)
            out = jnp.where(w_t[None] == w, field, out)
        return out.transpose(2, 1, 0).astype(jnp.uint8)  # (c, D, EB)

    if LOWDIM_IMPL == "wselect":
        return _chunked(chunk_wpack, nb, errs_zz, widths)
    if LOWDIM_IMPL == "jsel":
        return _chunked(chunk_jpack, nb, errs_zz, widths)
    if LOWDIM_IMPL == "auto":
        # pack impls tied in an earlier device A/B — einsum stands
        return _chunked(chunk, nb, errs_zz, widths)
    if LOWDIM_IMPL == "wbank":
        return _chunked(
            lambda e, w: pack_dims_lowdim_wbank(e, w, elem_sz),
            nb, errs_zz, widths)
    return _chunked(chunk_sel if LOWDIM_IMPL == "select" else chunk,
                    nb, errs_zz, widths)


@functools.lru_cache(maxsize=None)
def _wbank_unpack_table(eb: int) -> np.ndarray:
    """Static width-bank unpack weights (nw*8, EB) float32.

    Row wi*8 + r computes sample r's field ASSUMING width legal[wi]:
    lowdim sample r of a width-w dim lives at bits [r*w, r*w + w) of
    the dim's EB-byte section, so the field equals
    floor(sum_j bytes[j] * 2^(8j - r*w)) over the <=3 bytes the field
    touches — power-of-two weights fold the sub-byte shift INTO the
    matmul (the fractional bits are exactly the bits below the field
    and truncate away in the f32 -> i32 cast; every term and the sum
    span <= 24 bits, so bf16-operand/f32-accumulate dots are exact).
    One STATIC weight shared by every block replaces the
    per-(block, dim, sample) one-hot tensor — 16 B of weights per
    decoded sample in the einsum formulation."""
    legal = [0] + _lowdim_widths(eb)
    tbl = np.zeros((len(legal) * BLOCK_SZ, eb), np.float32)
    for wi, w in enumerate(legal):
        for r in range(BLOCK_SZ):
            br = r * w
            for j in range(eb):
                if 8 * j + 8 > br and 8 * j < br + w:
                    tbl[wi * BLOCK_SZ + r, j] = float(2.0 ** (8 * j - br))
    return tbl


@functools.lru_cache(maxsize=None)
def _wbank_pack_table(eb: int) -> np.ndarray:
    """Static width-bank pack weights (nw*EB, planes*8) float32 — the
    transpose of the unpack bank over byte planes: output byte j of a
    width-w dim is floor(sum_r sample_r * 2^(r*w - 8j)) & 255 (sample
    byte planes ride separate rows for u16 so every bf16 operand is a
    byte). Fractional parts are bits below byte j and are bit-disjoint
    across samples (fields never overlap), so they sum < 1 and the
    f32 -> i32 truncation is exact."""
    legal = [0] + _lowdim_widths(eb)
    planes = eb // 8
    tbl = np.zeros((len(legal) * eb, planes * BLOCK_SZ), np.float32)
    for wi, w in enumerate(legal):
        for j in range(eb):
            for p in range(planes):
                for r in range(BLOCK_SZ):
                    br = r * w + 8 * p  # plane p holds sample bits 8p..
                    if br + min(w, 8) > 8 * j and br < 8 * j + 8:
                        tbl[wi * eb + j, p * BLOCK_SZ + r] = float(
                            2.0 ** (br - 8 * j))
    return tbl


def unpack_dims_lowdim_wbank(dense: jnp.ndarray, widths: jnp.ndarray
                             ) -> jnp.ndarray:
    """Width-bank lowdim unpack (bit-identical to unpack_dims_lowdim).

    dense: (c, M, EB) bytes; widths: (c, M). Returns (c, 8, M) int32.
    ONE static-weight MXU dot computes every sample for every legal
    width; a per-width select keeps the real one. All N-scale tensors
    are (c, k, M) — full-lane when called on grouped M ~ 128 layouts.
    """
    c, m, eb = dense.shape
    bank = jnp.asarray(_wbank_unpack_table(eb))  # (nw*8, EB)
    d_t = dense.transpose(0, 2, 1).astype(jnp.bfloat16)  # (c, EB, M)
    t2 = jax.lax.dot_general(
        jnp.broadcast_to(bank.astype(jnp.bfloat16), (c,) + bank.shape),
        d_t, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32).astype(jnp.int32)
    legal = [0] + _lowdim_widths(eb)
    w32 = widths.astype(jnp.int32)
    word = jnp.zeros((c, BLOCK_SZ, m), jnp.int32)
    for wi, w in enumerate(legal):
        if w == 0:
            continue
        word = jnp.where(w32[:, None, :] == w,
                         t2[:, wi * BLOCK_SZ:(wi + 1) * BLOCK_SZ], word)
    return word & ((1 << w32)[:, None, :] - 1)


def pack_dims_lowdim_wbank(errs_zz: jnp.ndarray, widths: jnp.ndarray,
                           elem_sz: int) -> jnp.ndarray:
    """Width-bank lowdim pack (bit-identical to pack_dims_lowdim).

    errs_zz: (c, 8, M) int32; widths: (c, M). Returns (c, M, EB) uint8.
    """
    c, _, m = errs_zz.shape
    eb = 8 * elem_sz
    bank = jnp.asarray(_wbank_pack_table(eb))  # (nw*EB, planes*8)
    planes = [((errs_zz >> (8 * p)) & 0xFF).astype(jnp.bfloat16)
              for p in range(elem_sz)]
    e_t = jnp.concatenate(planes, axis=1)  # (c, planes*8, M)
    t2 = jax.lax.dot_general(
        jnp.broadcast_to(bank.astype(jnp.bfloat16), (c,) + bank.shape),
        e_t, dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32).astype(jnp.int32)
    legal = [0] + _lowdim_widths(eb)
    w32 = widths.astype(jnp.int32)
    out = jnp.zeros((c, eb, m), jnp.int32)
    for wi, w in enumerate(legal):
        if w == 0:
            continue
        out = jnp.where(w32[:, None, :] == w,
                        t2[:, wi * eb:(wi + 1) * eb], out)
    return (out & 0xFF).transpose(0, 2, 1).astype(jnp.uint8)


def unpack_rows_rowmajor(dense: jnp.ndarray, widths: jnp.ndarray,
                         pair: bool = False,
                         off: jnp.ndarray | None = None,
                         chunk_blocks: int | None = None,
                         *, elem_sz: int) -> jnp.ndarray:
    """Extract per-dim fields from packed rows.

    dense: (nb, 8, MAXB) int32 bytes (payload rows, zero padded);
    widths: (nb, D) int32. Returns errs_zz (nb, 8, D) int32.
    ``pair``: paired-dim extraction — one matmul window per dim PAIR,
    halving the weight tensor. VALID ONLY when every width <= 8 (u8
    streams); callers gate on elem_sz.
    ``off``: precomputed (nb, D) bit offsets overriding the in-chunk
    widths cumsum (the block-folded decode pass packs G real blocks
    into one virtual row, so dim g*D+d starts at g*8*maxb + own off).
    ``elem_sz``: element bytes of the STREAM the widths came from
    (required); sets the byte-window count (u8 fields span <= 2 bytes —
    see _nwin), so a u16 stream read with elem_sz=1 would lose bits.
    """
    nb, _, maxb = dense.shape
    ndims = widths.shape[1]
    nwin = _nwin(elem_sz)
    j = jnp.arange(maxb)

    def chunk(dense_c, widths_c, off_c=None):
        off = (jnp.cumsum(widths_c, axis=1) - widths_c
               if off_c is None else off_c.astype(jnp.int32))
        q = off >> 3  # (c, D)
        if UNPACK_WLAYOUT == "dot":
            # build the weight directly in the dot's (c, MAXB, D)
            # operand layout: the intermediate minor dim is D (2x lane
            # pad at D=64) instead of MAXB=32 (4x), and no transpose
            rel = j[None, :, None] - q[:, None, :]  # (c, MAXB, D)
            w3 = jnp.where(rel == 2, 65536.0, 0.0) if nwin == 3 else 0.0
            w = jnp.where(rel == 0, 1.0, jnp.where(rel == 1, 256.0, w3))
            word = _matmul_exact(dense_c, w)  # (c, 8, D)
        else:
            rel = j[None, None, :] - q[:, :, None]  # (c, D, MAXB)
            w3 = jnp.where(rel == 2, 65536.0, 0.0) if nwin == 3 else 0.0
            w = jnp.where(rel == 0, 1.0, jnp.where(rel == 1, 256.0, w3))
            word = _matmul_exact(dense_c, w.transpose(0, 2, 1))  # (c, 8, D)
        word = word >> (off & 7)[:, None, :]
        return word & ((1 << widths_c)[:, None, :] - 1)

    def chunk_bf3(dense_c, widths_c, off_c=None):
        # Shifted-payload extraction (round-5 roofline consequence): the
        # weight is ONE {0,1} byte-select one-hot — a single compare
        # over the (c, MAXB, D) tensor instead of the 3-level where
        # chain (the measured VPU wall of the weight BUILD) — and bytes
        # k = 1..nwin-1 come from byte-shifted payload copies stacked on
        # the dot's tiny M axis (8 -> 8*nwin rows; M=8 leaves the MXU
        # idle, so the extra rows are near-free). Combine in f32:
        # b0 + 256*b1 + 65536*b2 <= 2^24 - 1, exact. Same structure as
        # chunk_s8, whose loss was the s8 dot LOWERING, not the shape.
        off = (jnp.cumsum(widths_c, axis=1) - widths_c
               if off_c is None else off_c.astype(jnp.int32))
        q = off >> 3  # (c, D)
        oh = (j[None, :, None] == q[:, None, :]).astype(jnp.bfloat16)
        d8 = dense_c.astype(jnp.bfloat16)  # (c, 8, MAXB)
        z1 = jnp.zeros_like(d8[:, :, :1])
        copies = [d8]
        for k in range(1, nwin):
            copies.append(jnp.concatenate(
                [d8[:, :, k:]] + [z1] * k, axis=2))
        dcat = jnp.concatenate(copies, axis=1)  # (c, 8*nwin, MAXB)
        b = jax.lax.dot_general(
            dcat, oh,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)  # (c, 8*nwin, D)
        word = b[:, :BLOCK_SZ]
        for k in range(1, nwin):
            word = word + b[:, k * BLOCK_SZ:(k + 1) * BLOCK_SZ] * float(
                1 << (8 * k))
        word = word.astype(jnp.int32) >> (off & 7)[:, None, :]
        return word & ((1 << widths_c)[:, None, :] - 1)

    def chunk_s8(dense_c, widths_c):
        # One {0,1} int8 one-hot selects each dim's FIRST byte; bytes 2-3
        # come from byte-shifted copies of the payload sharing the same
        # weights (one weight read, three row groups in one matmul).
        # Bias: biased bytes d-128 and sum_j onehot[j,d] == 1 per dim,
        # so the correction is the constant +128.
        off = jnp.cumsum(widths_c, axis=1) - widths_c
        q = off >> 3  # (c, D)
        onehot = (q[:, None, :] == j[None, :, None]).astype(jnp.int8)
        d8 = (dense_c - 128).astype(jnp.int8)  # (c, 8, MAXB)
        pad1 = jnp.full_like(d8[:, :, :1], -128)
        d3 = jnp.concatenate([
            d8,
            jnp.concatenate([d8[:, :, 1:], pad1], axis=2),
            jnp.concatenate([d8[:, :, 2:], pad1, pad1], axis=2),
        ], axis=1)  # (c, 24, MAXB)
        b = jax.lax.dot_general(
            d3, onehot,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32) + 128  # (c, 24, D)
        word = (b[:, :BLOCK_SZ]
                + (b[:, BLOCK_SZ: 2 * BLOCK_SZ] << 8)
                + (b[:, 2 * BLOCK_SZ:] << 16))
        word = word >> (off & 7)[:, None, :]
        return word & ((1 << widths_c)[:, None, :] - 1)

    def chunk_pair(dense_c, widths_c):
        # PAIRED-DIM extraction: u8 width pairs always satisfy
        # (off & 7) + w[2k] + w[2k+1] <= 7 + 16 = 23 bits, so ONE
        # 3-byte matmul window per dim PAIR covers both fields — the
        # (c, MAXB, D) weight tensor halves to (c, MAXB, D/2). The pair
        # word maxes at 255 * (1 + 256 + 65536) = 2^24 - 1, still exact
        # in f32. The lo/hi split + re-interleave are fused elementwise.
        c = dense_c.shape[0]
        dp = ndims + (ndims & 1)
        wp = widths_c.astype(jnp.int32)  # u8 widths overflow the cumsum
        if dp != ndims:  # odd D: one zero-width phantom dim
            wp = jnp.concatenate(
                [wp, jnp.zeros((c, 1), wp.dtype)], axis=1)
        off = jnp.cumsum(wp, axis=1) - wp  # (c, Dp)
        offp = off[:, 0::2]  # (c, Dp/2) pair start bit offsets
        q = offp >> 3
        rel = j[None, None, :] - q[:, :, None]  # (c, Dp/2, MAXB)
        w = jnp.where(rel == 0, 1.0,
                      jnp.where(rel == 1, 256.0,
                                jnp.where(rel == 2, 65536.0, 0.0)))
        word = _matmul_exact(dense_c, w.transpose(0, 2, 1))  # (c, 8, Dp/2)
        word = jax.lax.shift_right_logical(word, (offp & 7)[:, None, :])
        w0 = wp[:, 0::2][:, None, :]  # (c, 1, Dp/2)
        w1 = wp[:, 1::2][:, None, :]
        lo = word & ((1 << w0) - 1)
        hi = jax.lax.shift_right_logical(word, w0) & ((1 << w1) - 1)
        errs = jnp.stack([lo, hi], axis=-1).reshape(c, BLOCK_SZ, dp)
        return errs[:, :, :ndims]

    def chunk_wordsel(dense_c, widths_c):
        # Matmul-free extraction: bitcast each row's
        # MAXB bytes to MAXB/4 u32 words; every field (width <= 16)
        # spans <= 2 consecutive words, selected by a W32-deep where
        # chain and funnel-shifted. The one-hot weight BUILD the matmul
        # path pays ((c, D, MAXB) elements x ~7 ops) shrinks to
        # (c, 8, D) x ~(2*W32 + 8) ops — ~2x fewer at maxb=32, D=64.
        c0 = dense_c.shape[0]
        off = jnp.cumsum(widths_c, axis=1) - widths_c  # (c, D)
        w32 = maxb // 4
        words = jax.lax.bitcast_convert_type(
            dense_c.astype(jnp.uint8).reshape(c0, BLOCK_SZ, w32, 4),
            jnp.uint32)  # (c, 8, W32)
        q32 = (off >> 5)[:, None, :]  # (c, 1, D)
        lo = jnp.broadcast_to(words[:, :, :1],
                              (c0, BLOCK_SZ, ndims)) * 0
        hi = lo
        for j in range(w32):
            wj = words[:, :, j:j + 1]
            lo = jnp.where(q32 == j, wj, lo)
            hi = jnp.where(q32 + 1 == j, wj, hi)
        sh = (off & 31).astype(jnp.uint32)[:, None, :]
        # hi << (32 - sh) with sh possibly 0: split as (hi << 1) << (31 - sh)
        val = (lo >> sh) | ((hi << 1) << (31 - sh))
        return (val.astype(jnp.int32)
                & ((1 << widths_c)[:, None, :] - 1))

    main = chunk_bf3 if MXU_IMPL == "bf3" else chunk
    if off is not None:
        return _chunked(main, nb, dense, widths, off, chunk=chunk_blocks)
    if pair:
        return _chunked(chunk_pair, nb, dense, widths, chunk=chunk_blocks)
    if _wordsel_ok(maxb):
        return _chunked(chunk_wordsel, nb, dense, widths,
                        chunk=chunk_blocks)
    return _chunked(chunk_s8 if MXU_IMPL == "s8" else main,
                    nb, dense, widths, chunk=chunk_blocks)


def unpack_rows_ragged(dense_sorted: jnp.ndarray, widths_sorted: jnp.ndarray,
                       widths_u: jnp.ndarray, group_sizes: jnp.ndarray
                       ) -> jnp.ndarray:
    """Signature-grouped unpack via ``lax.ragged_dot`` — no per-block
    weight tensor.

    The standard unpack builds a (nb, MAXB, D) one-hot weight per block
    (~16x the payload bytes). Blocks sorted by width signature share
    weights: one (U, MAXB, D) table and a ragged dot over contiguous
    segments, with NO pow2 per-signature padding (unlike the grouped
    pass).

    dense_sorted: (nb, 8, MAXB) i32 payload bytes in signature order;
    widths_sorted: (nb, D) i32 (same order); widths_u: (U_pad, D) i32
    unique signatures; group_sizes: (U_pad,) i32 block counts (sum=nb).
    Returns errs_zz (nb, 8, D) i32 in the SORTED order.
    """
    nb, _, maxb = dense_sorted.shape
    ndims = widths_u.shape[1]
    j = jnp.arange(maxb)
    off_u = jnp.cumsum(widths_u, axis=1) - widths_u  # (U, D)
    rel = (off_u >> 3)[:, :, None] - j[None, None, :]  # (U, D, MAXB)
    w = jnp.where(rel == 0, 1.0,
                  jnp.where(rel == -1, 256.0,
                            jnp.where(rel == -2, 65536.0, 0.0)))
    word = jax.lax.ragged_dot(
        dense_sorted.reshape(nb * BLOCK_SZ, maxb).astype(jnp.bfloat16),
        w.transpose(0, 2, 1).astype(jnp.bfloat16),  # (U, MAXB, D)
        group_sizes * BLOCK_SZ,
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32).reshape(nb, BLOCK_SZ, ndims)
    off = jnp.cumsum(widths_sorted, axis=1) - widths_sorted  # (nb, D)
    word = word >> (off & 7)[:, None, :]
    return word & ((1 << widths_sorted)[:, None, :] - 1)


def unpack_dims_lowdim(dense: jnp.ndarray, widths: jnp.ndarray) -> jnp.ndarray:
    """Inverse of pack_dims_lowdim.

    dense: (nb, D, EB) int32 bytes; widths: (nb, D) int32.
    Returns errs_zz (nb, 8, D) int32.
    """
    nb, ndims, eb = dense.shape
    j = jnp.arange(eb)

    def chunk(dense_c, widths_c):
        cb = dense_c.shape[0]
        bitoff = jnp.arange(BLOCK_SZ)[None, :, None] * widths_c[:, None, :]
        q = bitoff >> 3  # (c, 8, D)
        rel = j[None, None, None, :] - q[..., None]  # (c, 8, D, EB)
        w = jnp.where(rel == 0, 1.0,
                      jnp.where(rel == 1, 256.0,
                                jnp.where(rel == 2, 65536.0, 0.0)))
        # word[b,r,d] = sum_j dense[b,d,j] * w[b,r,d,j]
        d_t = dense_c.transpose(0, 2, 1)  # (c, EB, D)
        word = jnp.einsum(
            "cjd,crdj->crd", d_t.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32).astype(jnp.int32)
        word = word >> (bitoff & 7)
        return word & ((1 << widths_c)[:, None, :] - 1)

    def chunk_e2(dense_c, widths_c):
        # Same one-hot contraction as ``chunk``, but every N-scale
        # tensor keeps (second-minor, minor) = (8-ish, D) — with the
        # grouped D ~ 128 these are full (8, 128) tiles, whereas
        # ``chunk``'s w has minor EB=8, which a 128-lane tiling pads
        # 16x.
        bitoff = jnp.arange(BLOCK_SZ)[None, :, None] * widths_c[:, None, :]
        q = bitoff >> 3  # (c, 8, D)
        rel = q[:, None] - j[None, :, None, None]  # (c, EB, 8, D)
        w = jnp.where(rel == 0, 1.0,
                      jnp.where(rel == -1, 256.0,
                                jnp.where(rel == -2, 65536.0, 0.0)))
        d_t = dense_c.transpose(0, 2, 1)  # (c, EB, D)
        word = jnp.einsum(
            "cjd,cjrd->crd", d_t.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32).astype(jnp.int32)
        word = word >> (bitoff & 7)
        return word & ((1 << widths_c)[:, None, :] - 1)

    def chunk_dyn(dense_c, widths_c):
        # Per-element variable-shift extraction, no matmul and no
        # per-width unroll: every N-scale tensor is (c, 8, D) — with the
        # grouped D ~ 128 a pure elementwise chain XLA can fuse into one
        # kernel whose cost is input+output traffic.
        cb, ndims_c, _ = dense_c.shape
        k32 = eb // 4  # u32 words per dim field
        words = jax.lax.bitcast_convert_type(
            dense_c.astype(jnp.uint8).reshape(cb, ndims_c, k32, 4),
            jnp.uint32)  # (c, D, k32)
        bitoff = (jnp.arange(BLOCK_SZ)[None, :, None]
                  * widths_c[:, None, :]).astype(jnp.uint32)  # (c, 8, D)
        q = bitoff >> 3

        def byte_at(qq):
            # byte qq of the field; qq may overrun into [EB, EB+2) for
            # narrow widths — the select falls back to word 0 and the
            # final width mask discards those bits.
            g = qq >> 2
            out = jnp.broadcast_to(words[:, None, :, 0], qq.shape)
            for gi in range(1, k32):
                out = jnp.where(g == gi, words[:, None, :, gi], out)
            return (out >> ((qq & 3) << 3)) & 0xFF

        word = byte_at(q) | (byte_at(q + 1) << 8)
        if eb > 8:
            word = word | (byte_at(q + 2) << 16)
        word = word >> (bitoff & 7)
        mask = ((1 << widths_c) - 1).astype(jnp.uint32)
        return (word & mask[:, None, :]).astype(jnp.int32)

    def chunk_sel(dense_c, widths_c):
        # VPU select-accumulate, block axis minor (lanes = blocks): each
        # sample's 3-byte window gathers as masked sums over the EB
        # payload bytes of its dim.
        w_t = widths_c.T  # (D, c)
        bitoff = jnp.arange(BLOCK_SZ)[:, None, None] * w_t[None]  # (8,D,c)
        q = bitoff >> 3
        d_t = dense_c.transpose(2, 1, 0)  # (EB, D, c)
        rel = j[None, :, None, None] - q[:, None, :, :]  # (8, EB, D, c)
        b = d_t[None]  # (1, EB, D, c)
        word = jnp.sum(jnp.where(rel == 0, b, 0)
                       + jnp.where(rel == 1, b << 8, 0)
                       + jnp.where(rel == 2, b << 16, 0),
                       axis=1)  # (8, D, c)
        word = word >> (bitoff & 7)
        word = word & ((1 << w_t)[None] - 1)
        return word.transpose(2, 0, 1)  # (c, 8, D)

    def chunk_jsel(dense_c, widths_c):
        # Fused-select (the einsum materializes an (., EB)-minor
        # reduce). Here every
        # tensor is (c, 8, D) with D the folded ~128-lane axis: the
        # byte window is built by EB static selects per byte (d_t rows
        # broadcast over r), one variable shift at the end. XLA fuses
        # the whole chain into one elementwise kernel whose traffic is
        # payload + offsets + output only.
        bitoff = jnp.arange(BLOCK_SZ)[None, :, None] * widths_c[:, None, :]
        q = bitoff >> 3  # (c, 8, D)
        d_t = dense_c.transpose(0, 2, 1)  # (c, EB, D)

        def byte_at(qq):
            out = jnp.zeros_like(qq)
            for jj in range(eb):  # static EB-way select
                out = jnp.where(qq == jj, d_t[:, jj][:, None, :], out)
            return out

        word = byte_at(q) | (byte_at(q + 1) << 8)
        if eb > 8:
            word = word | (byte_at(q + 2) << 16)
        word = word >> (bitoff & 7)
        return word & ((1 << widths_c)[:, None, :] - 1)

    def chunk_wsel(dense_c, widths_c):
        # Width-stratified (see chunk_wpack): per legal width w the
        # sample windows sit at STATIC byte offsets (bit r*w), so each
        # extraction is 1-3 static byte-plane slices + shift + mask; one
        # select per width combines them. The window never leaves the
        # dim's w-byte field, so the static indices stay in range.
        d_t = dense_c.transpose(1, 2, 0)  # (D, EB, c)
        w_t = widths_c.T  # (D, c)
        out = jnp.zeros((BLOCK_SZ, ndims, dense_c.shape[0]), jnp.int32)
        for w in _lowdim_widths(eb):
            rows = []
            for r in range(BLOCK_SZ):
                br = r * w
                q, s = br >> 3, br & 7
                word = d_t[:, q]
                if s + w > 8:
                    word = word | (d_t[:, q + 1] << 8)
                if s + w > 16:
                    word = word | (d_t[:, q + 2] << 16)
                rows.append((word >> s) & ((1 << w) - 1))
            out = jnp.where(w_t[None] == w, jnp.stack(rows), out)
        return out.transpose(2, 0, 1)  # (c, 8, D)

    def chunk_wsel32(dense_c, widths_c):
        # Word-granular select (the lowdim twin of the
        # rowmajor wordsel that won every maxb-8 cell): the EB payload
        # bytes of a dim are EB/4 u32 words, each sample field spans
        # <= 2 of them — a (EB/4)-deep lo/hi select + ONE funnel shift
        # replaces jsel's 3 x EB-way byte selects (~4x fewer ops).
        cb, ndims_c, _ = dense_c.shape
        k32 = eb // 4
        words = jax.lax.bitcast_convert_type(
            dense_c.astype(jnp.uint8).reshape(cb, ndims_c, k32, 4),
            jnp.uint32)  # (c, D, k32)
        bitoff = (jnp.arange(BLOCK_SZ)[None, :, None]
                  * widths_c[:, None, :])  # (c, 8, D)
        q = bitoff >> 5
        lo = jnp.broadcast_to(words[:, None, :, 0], q.shape)
        hi = jnp.zeros(q.shape, jnp.uint32)
        for jj in range(1, k32):
            wj = words[:, None, :, jj]
            lo = jnp.where(q == jj, wj, lo)
            hi = jnp.where(q + 1 == jj, wj, hi)
        sh = (bitoff & 31).astype(jnp.uint32)
        val = (lo >> sh) | ((hi << 1) << (31 - sh))
        return (val.astype(jnp.int32)
                & ((1 << widths_c)[:, None, :] - 1))

    impl = LOWDIM_IMPL
    if impl == "auto":
        # an earlier device A/B chose jsel for the small-D u8 unpack
        # and the einsum inside the grouped fold and at u16 (48-select
        # chains); not re-measured on the H100.
        impl = "jsel" if (eb == 8 and ndims <= 4) else "einsum"
    if impl == "wselect":
        return _chunked(chunk_wsel, nb, dense, widths)
    if impl == "einsum2":
        return _chunked(chunk_e2, nb, dense, widths)
    if impl == "dyn":
        return _chunked(chunk_dyn, nb, dense, widths)
    if impl == "jsel":
        return _chunked(chunk_jsel, nb, dense, widths)
    if impl == "wsel32":
        return _chunked(chunk_wsel32, nb, dense, widths)
    if impl == "wbank":
        return _chunked(unpack_dims_lowdim_wbank, nb, dense, widths)
    return _chunked(chunk_sel if impl == "select" else chunk,
                    nb, dense, widths)


def lowdim_group(ndims: int) -> int:
    """Blocks folded per einsum batch so the virtual dim axis ~ 128."""
    return max(1, 128 // ndims)


def unpack_dims_lowdim_grouped(dense: jnp.ndarray, widths: jnp.ndarray,
                               group: int = 0) -> jnp.ndarray:
    """Grouped lowdim unpack, bit-identical to ``unpack_dims_lowdim``.

    The plain batched einsum is lane-starved at D<=4 (its batch minor
    dims are (D, EB)); every dim field decodes independently, so G
    consecutive blocks fold into G*D ~ 128 virtual dims — the exact
    shape of the fast rowmajor unpack — and unfold afterwards.
    dense: (nb, D, EB) bytes; widths: (nb, D). Returns (nb, 8, D) int32.
    """
    nb, ndims, eb = dense.shape
    nd0 = ndims
    if ndims == 3 and LOWDIM_D3 != "native":
        # 3 does not divide 128: fold as d4 with a zero-width 4th dim
        # (independent per-dim sections make the pad free; every view
        # stays minor-4 instead of the pathological minor-3).
        # "native" folds g=42 real d3 blocks (126 of 128 lanes).
        dense = jnp.concatenate(
            [dense, jnp.zeros((nb, 1, eb), dense.dtype)], axis=1)
        widths = jnp.concatenate(
            [widths, jnp.zeros((nb, 1), widths.dtype)], axis=1)
        ndims = 4
    g = group or lowdim_group(ndims)
    pad = (-nb) % g
    if pad:
        dense = jnp.concatenate(
            [dense, jnp.zeros((pad, ndims, eb), dense.dtype)])
        widths = jnp.concatenate(
            [widths, jnp.zeros((pad, ndims), widths.dtype)])
    c = (nb + pad) // g
    errs = unpack_dims_lowdim(dense.reshape(c, g * ndims, eb),
                              widths.reshape(c, g * ndims))  # (c, 8, G*D)
    errs = errs.reshape(c, BLOCK_SZ, g, ndims).swapaxes(1, 2)
    return errs.reshape(c * g, BLOCK_SZ, ndims)[:nb, :, :nd0]


def pack_dims_lowdim_grouped(errs_zz: jnp.ndarray, widths: jnp.ndarray,
                             elem_sz: int, group: int = 0) -> jnp.ndarray:
    """Grouped twin of ``pack_dims_lowdim`` (bit-identical output).

    errs_zz: (nb, 8, D) int32; widths: (nb, D). Returns (nb, D, EB) u8.
    """
    nb, _, ndims = errs_zz.shape
    nd0 = ndims
    if ndims == 3 and LOWDIM_D3 != "native":
        # fold as d4 (see unpack_dims_lowdim_grouped)
        errs_zz = jnp.concatenate(
            [errs_zz, jnp.zeros((nb, BLOCK_SZ, 1), errs_zz.dtype)],
            axis=2)
        widths = jnp.concatenate(
            [widths, jnp.zeros((nb, 1), widths.dtype)], axis=1)
        ndims = 4
    g = group or lowdim_group(ndims)
    pad = (-nb) % g
    if pad:
        errs_zz = jnp.concatenate(
            [errs_zz, jnp.zeros((pad, BLOCK_SZ, ndims), errs_zz.dtype)])
        widths = jnp.concatenate(
            [widths, jnp.zeros((pad, ndims), widths.dtype)])
    c = (nb + pad) // g
    eg = errs_zz.reshape(c, g, BLOCK_SZ, ndims).swapaxes(1, 2)
    dense = pack_dims_lowdim(eg.reshape(c, BLOCK_SZ, g * ndims),
                             widths.reshape(c, g * ndims), elem_sz)
    return dense.reshape(c * g, ndims, 8 * elem_sz)[:nb, :nd0]


def unpack_dims_lowdim_dmajor(dense: jnp.ndarray, widths: jnp.ndarray
                              ) -> list[jnp.ndarray]:
    """Dim-major lowdim unpack: (nb, D, EB) uint8 -> 8 x (D, nb) int32.

    A 128-lane tiling pads the minor dim, so any (.., D<=4)- or
    (.., 8)-minor tensor pays a 16-32x traffic bloat. Here
    NOTHING small-minor is ever materialized: payload bytes become
    (D, EB, nb) planes via one u32-word transpose, extraction is
    width-stratified static shifts on (D, nb) slices (lowdim bit
    offsets are r*w — no cross-dim cumsum), and the 8 sample slots stay
    separate (D, nb) arrays for the caller to prefix/interleave with
    word tricks.
    """
    nb, ndims, eb = dense.shape
    k32 = ndims * eb // 4
    words = jax.lax.bitcast_convert_type(
        dense.astype(jnp.uint8).reshape(nb, k32, 4), jnp.uint32)
    words = jnp.swapaxes(words, -1, -2).astype(jnp.int32)  # (k32, nb)
    planes = jnp.stack([
        (words[(d * eb + j) // 4] >> (8 * (j % 4))) & 0xFF
        for d in range(ndims) for j in range(eb)
    ]).reshape(ndims, eb, nb)
    w_t = jnp.swapaxes(widths, -1, -2).astype(jnp.int32)  # (D, nb)
    rows = []
    for r in range(BLOCK_SZ):
        out_r = jnp.zeros((ndims, nb), jnp.int32)
        for w in _lowdim_widths(eb):
            br = r * w
            q, s = br >> 3, br & 7
            word = planes[:, q]
            if s + w > 8:
                word = word | (planes[:, q + 1] << 8)
            if s + w > 16:
                word = word | (planes[:, q + 2] << 16)
            out_r = jnp.where(w_t == w, (word >> s) & ((1 << w) - 1), out_r)
        rows.append(out_r)
    return rows


def pack_fields_lowdim_dmajor(slots: list[jnp.ndarray], widths: jnp.ndarray,
                              elem_sz: int) -> jnp.ndarray:
    """Dim-major lowdim pack: 8 x (D, nb) zigzag errs -> (nb, D, EB) u8.

    Encode-side twin of ``unpack_dims_lowdim_dmajor``: field bytes are
    emitted with width-stratified static shifts on (D, nb) slices, the
    per-dim EB bytes assemble into u32 words on full-lane arrays, and
    one small-minor u32 transpose + free bitcast produces the
    (nb, D, EB) layout the host assembler slices. Output bytes are
    bit-identical to pack_dims_lowdim.
    """
    eb = 8 * elem_sz
    ndims, nb = slots[0].shape
    fields = []
    for jbyte in range(eb):
        out_j = jnp.zeros((ndims, nb), jnp.int32)
        for w in _lowdim_widths(eb):
            if w <= jbyte:
                continue  # a w-bit field occupies w bytes
            acc = None
            for r in range(BLOCK_SZ):
                br = r * w
                if br + w <= 8 * jbyte or br >= 8 * (jbyte + 1):
                    continue
                sh = br - 8 * jbyte
                term = slots[r] << sh if sh >= 0 else slots[r] >> -sh
                acc = term if acc is None else acc | term
            out_j = jnp.where(widths == w, acc & 0xFF, out_j)
        fields.append(out_j.astype(jnp.uint32))
    words = jnp.stack([
        fields[4 * g] | (fields[4 * g + 1] << 8)
        | (fields[4 * g + 2] << 16) | (fields[4 * g + 3] << 24)
        for g in range(eb // 4)
    ])  # (G, D, nb)
    flat = jnp.swapaxes(words, 0, 1).reshape(ndims * (eb // 4), nb)
    rows = jnp.swapaxes(flat, -1, -2)  # (nb, D*G) — the one small-minor op
    return jax.lax.bitcast_convert_type(
        rows, jnp.uint8).reshape(nb, ndims, eb)


def unpack_dims_lowdim_dynshift(dense: jnp.ndarray, widths: jnp.ndarray
                                ) -> list[jnp.ndarray]:
    """Dynamic-shift lowdim unpack: (nb, D, EB) u8 -> 8 x (D, nb) int32.

    The width-stratified formulations cost ~200 small ops. Here there
    is NO
    per-width unroll: a dim's field is 2 (u8) or 4 (u16) u32 words, and
    sample r's window is extracted with per-element VARIABLE shifts —
    an elementwise op. ~6 ops per byte of the
    3-byte window, on (D, nb) full-minor arrays.
    """
    nb, ndims, eb = dense.shape
    k32 = eb // 4  # u32 words per dim field: 2 (u8) / 4 (u16)
    words = jax.lax.bitcast_convert_type(
        dense.astype(jnp.uint8).reshape(nb, ndims * k32, 4), jnp.uint32)
    words = jnp.swapaxes(words, -1, -2)  # (D*k32, nb) u32
    wlist = [words[d * k32 + g].astype(jnp.int32)
             for d in range(ndims) for g in range(k32)]

    stackw = jnp.stack([jnp.stack(wlist[d * k32: (d + 1) * k32])
                        for d in range(ndims)])  # (D, k32, nb)

    def getword(g_idx):
        """Word g_idx (D, nb) where g_idx is a traced (D, nb) int32 in
        [0, k32): a select chain over the k32 static words. Out-of-range
        indices return word 0 — callers only read bytes the width mask
        discards in that case."""
        out = stackw[:, 0]
        for g in range(1, k32):
            out = jnp.where(g_idx == g, stackw[:, g], out)
        return out

    w_t = jnp.swapaxes(widths, -1, -2).astype(jnp.int32)  # (D, nb)
    mask = (1 << w_t) - 1
    slots = []
    for r in range(BLOCK_SZ):
        br = r * w_t  # (D, nb) dynamic bit offset
        q = br >> 3
        s = br & 7

        def byte_at(qq):
            w32 = getword(qq >> 2)
            return (w32 >> ((qq & 3) << 3)) & 0xFF

        word = byte_at(q) | (byte_at(q + 1) << 8)
        if eb > 8:
            word = word | (byte_at(q + 2) << 16)
        slots.append((word >> s) & mask)
    return slots


def pack_fields_lowdim_dynshift(slots: list[jnp.ndarray],
                                widths: jnp.ndarray, elem_sz: int
                                ) -> jnp.ndarray:
    """Dynamic-shift lowdim pack: 8 x (D, nb) errs -> (nb, D, EB) u8.

    Encode twin of ``unpack_dims_lowdim_dynshift``: each sample ORs its
    w bits into the dim field's u32 words with per-element variable
    shifts (shift amounts masked into [0, 31]; straddle parts routed by
    selects). Bytes are bit-identical to pack_dims_lowdim.
    """
    eb = 8 * elem_sz
    ndims, nb = slots[0].shape
    k32 = eb // 4
    w_t = widths.astype(jnp.uint32)  # (D, nb)
    accs = [jnp.zeros((ndims, nb), jnp.uint32) for _ in range(k32)]
    for r in range(BLOCK_SZ):
        e = slots[r].astype(jnp.uint32)
        br = r * w_t  # bit offset within the field, < 8*EB
        for g in range(k32):
            # contribution of sample r to word g: bits [32g, 32g+32)
            rel = br.astype(jnp.int32) - 32 * g  # signed offset into word
            lsh = (e << (rel.astype(jnp.uint32) & 31))
            rsh = (e >> ((-rel).astype(jnp.uint32) & 31))
            contrib = jnp.where(rel >= 0,
                                jnp.where(rel < 32, lsh, 0),
                                jnp.where(rel > -32, rsh, 0))
            accs[g] = accs[g] | contrib
    flat = jnp.stack([accs[g][d] for d in range(ndims)
                      for g in range(k32)])  # (D*k32, nb)
    rows = jnp.swapaxes(flat, -1, -2)  # (nb, D*k32)
    return jax.lax.bitcast_convert_type(
        rows, jnp.uint8).reshape(nb, ndims, eb)


def interleave_rows_dmajor(slots: list[jnp.ndarray], elem_sz: int
                           ) -> jnp.ndarray:
    """8 x (D, nb) int32 sample slots -> (nb*8, D) narrow rows.

    Each slot's row packs into one <= 32-bit word on full-lane (nb,)
    arrays; ONE (8, nb) -> (nb, 8) word transpose performs the whole
    time interleave, and a free bitcast splits dims back out. Requires
    D * elem_sz in {1, 2, 4}.
    """
    ndims, nb = slots[0].shape
    ebits = 8 * elem_sz
    mask = (1 << ebits) - 1
    row_b = ndims * elem_sz

    def rowword(v):
        vu = v.astype(jnp.uint32) & mask
        w = vu[0]
        for d in range(1, ndims):
            w = w | (vu[d] << (ebits * d))
        if row_b == 1:
            return w.astype(jnp.uint8)
        if row_b == 2:
            return w.astype(jnp.uint16)
        return w

    wt = jnp.swapaxes(jnp.stack([rowword(v) for v in slots]), -1, -2)
    udt = jnp.uint8 if elem_sz == 1 else jnp.uint16
    if ndims > 1:
        wt = jax.lax.bitcast_convert_type(wt, udt)  # (nb, 8, D)
    return wt.reshape(nb * BLOCK_SZ, ndims)


def pack_rows_from_dmajor(vals: jnp.ndarray, elem_sz: int) -> jnp.ndarray:
    """(D, N) int32 dim-major values -> (N, D) narrow rows.

    A row of D*elem_sz <= 4 bytes IS one machine word, so the
    dim-planes -> rows conversion is shift/OR on (N,) arrays plus a free
    bitcast — no lane-starved (N, D)-minor transpose. Requires
    D * elem_sz in {1, 2, 4}.
    """
    ndims = vals.shape[0]
    row_b = ndims * elem_sz
    udt = jnp.uint8 if elem_sz == 1 else jnp.uint16
    if ndims == 1:
        return vals[0].astype(udt)[:, None]
    ebits = 8 * elem_sz
    mask = (1 << ebits) - 1
    vu = vals.astype(jnp.uint32)
    if row_b == 2:  # two u8 dims -> one u16 word
        packed = ((vu[0] & 0xFF) | ((vu[1] & 0xFF) << 8)).astype(jnp.uint16)
        return jax.lax.bitcast_convert_type(packed, jnp.uint8)
    assert row_b == 4, "dmajor rows must be 1, 2 or 4 bytes"
    if ndims == 2:  # two u16 dims -> one u32 word
        packed = (vu[0] & mask) | ((vu[1] & mask) << 16)
        return jax.lax.bitcast_convert_type(packed, jnp.uint16)
    packed = ((vu[0] & 0xFF) | ((vu[1] & 0xFF) << 8)
              | ((vu[2] & 0xFF) << 16) | ((vu[3] & 0xFF) << 24))
    return jax.lax.bitcast_convert_type(packed, jnp.uint8)
