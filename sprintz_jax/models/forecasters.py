"""JAX forecasters: delta (parallel prefix) and FIRE (block scan).

Design notes:
- All lane math runs in int32; the reference's
  i8/i16 wraparound and narrowing truncations are reproduced with
  mask+sign-extend, verified bit-exact against the golden predictors.
- Delta is an exact prefix sum, so encode is a shifted subtract and decode
  a single cumulative sum over rows: fully parallel.
- FIRE's coefficient update is a data-dependent nonlinear recurrence
  (sprintz_xff_rle.cpp:199-276), so it scans over blocks with the 8-row
  inner loop unrolled and all dims (and any batched streams) vectorized in
  lanes. Throughput comes from the dim/stream axes, matching SURVEY §5's
  long-context analysis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..constants import BLOCK_SZ, FIRE_LEARNING_SHIFT
from ..ops.bitmath import sign_extend, zigzag_decode, zigzag_encode

# ------------------------------------------------------------------ delta


def delta_encode(rows: jnp.ndarray, elem_bits: int) -> jnp.ndarray:
    """rows: (N, D) int32 holding unsigned values -> zigzag errs (N, D) int32."""
    prev = jnp.concatenate([jnp.zeros_like(rows[:1]), rows[:-1]], axis=0)
    deltas = sign_extend(rows - prev, elem_bits)
    return zigzag_encode(deltas, elem_bits)


# Number format for the triangular prefix matmul, independent of the
# pack/unpack format (ops/pack.MXU_IMPL). Both formats are exact; s8 and
# chunk 256 are defaults from an earlier device A/B, not yet re-measured
# on the H100 (ROADMAP Queue 1 item 5).
PREFIX_IMPL = config.get("SPRINTZ_PREFIX_IMPL")

# Fold the chunk axis into the triangular matmul's minor dimension when
# the natural minor dim (planes*F) is narrow: lowdim streams have
# F = 2..4 dims. "auto" never folds (an earlier device A/B found no
# gain); the flag remains for A/B ("1" forces on, "0" off).
PREFIX_FOLD = config.get("SPRINTZ_PREFIX_FOLD")

# lax.scan unroll for the FIRE block scan: amortizes per-step scan
# overhead across blocks (the carry chain is the only sequential
# dependency). Read at trace time. 8 on every backend: on XLA:CPU an
# unroll of 32 sends LLVM into a >15-minute compile, and on the H100
# (PERF.md, bring-up sweeps) larger unrolls multiply the compile time of
# every FIRE program until a GPU scan kernel replaces the lax.scan
# (ROADMAP Queue 1 item 6).
SCAN_UNROLL = config.get("SPRINTZ_SCAN_UNROLL")


def _prefix_fold(pf: int) -> bool:
    """Whether to fold chunks into the triangular matmul's minor dim."""
    if PREFIX_FOLD == "auto":
        return False  # an earlier device A/B: folding never won
    return PREFIX_FOLD == "1"


def hierarchical_cumsum(x: jnp.ndarray, chunk: int = 256,
                        value_bits: int = 16) -> jnp.ndarray:
    """Two-level inclusive prefix sum along axis 0 of (N, ...) int arrays.

    Precondition: every value fits a signed ``value_bits``-bit integer
    (value_bits <= 16) — true for sign-extended u8/u16 deltas.

    A monolithic long-axis cumsum can cost O(log N) full-array memory
    passes. Here the intra-chunk prefix is ONE pass: a lower-triangular
    matmul, plus a tiny cross-chunk offset scan.

    Exactness: matmuls at *default* precision may round f32 inputs
    (bf16 on some accelerators, TF32 on NVIDIA GPUs), which would
    silently corrupt sums of full-magnitude i16 deltas. So the inputs
    are decomposed into biased byte planes — integers in [0, 256) are
    bf16-exact — and each plane's triangular matmul takes bf16 operands
    with f32 accumulation (PREFIX_IMPL=bf16) or s8 operands with s32
    accumulation (s8), where all partial sums stay <= chunk * 255 <
    2^17 << 2^24, i.e. exact integer arithmetic. The planes recombine
    in int32.
    """
    n = x.shape[0]
    if n <= chunk:
        return jnp.cumsum(x, axis=0, dtype=jnp.int32)
    pad = (-n) % chunk
    xp = jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
    trailing = x.shape[1:]
    c = xp.reshape(-1, chunk, int(np.prod(trailing)) if trailing else 1)
    nchunks, _, f = c.shape
    counts = (jnp.arange(chunk, dtype=jnp.int32) + 1)[None, :, None]
    two_planes = value_bits > 8
    if PREFIX_IMPL == "s8":
        # s8*s8->s32 matmul: sign-extended deltas (u8) and the
        # lo/hi planes of u16 deltas fit int8 (lo biased by -128); partial
        # sums stay <= chunk * 128 < 2^16, exact in s32.
        if two_planes:
            planes = jnp.concatenate(
                [(c & 0xFF) - 128, c >> 8], axis=-1).astype(jnp.int8)
        else:
            planes = c.astype(jnp.int8)
        tri = jnp.tril(jnp.ones((chunk, chunk), jnp.int8))
        if _prefix_fold(planes.shape[-1]):
            pl = jnp.moveaxis(planes, 0, 1).reshape(chunk, -1)
            inner = jax.lax.dot_general(
                tri, pl, dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32
            ).reshape(chunk, nchunks, planes.shape[-1])
        else:
            inner = jax.lax.dot_general(
                tri, planes, dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32)  # (chunk, nchunks, P*F)
        inner = jnp.moveaxis(inner, 0, 1)
        if two_planes:
            inner = (inner[..., :f] + (counts << 7)
                     + (inner[..., f:] << 8))
        totals = inner[:, -1]
        offsets = jnp.cumsum(totals, axis=0, dtype=jnp.int32) - totals
        out = inner + offsets[:, None]
        return (out.reshape(-1, *trailing)[:n] if trailing
                else out.reshape(-1)[:n])
    if two_planes:
        # x = lo + 256*hi with lo in [0,256), hi+128 in [0,256)
        planes = jnp.concatenate(
            [c & 0xFF, (c >> 8) + 128], axis=-1).astype(jnp.bfloat16)
    else:
        planes = (c + 128).astype(jnp.bfloat16)  # x+128 in [0,256)
    tri = jnp.tril(jnp.ones((chunk, chunk), jnp.bfloat16))
    if _prefix_fold(planes.shape[-1]):
        pl = jnp.moveaxis(planes, 0, 1).reshape(chunk, -1)
        inner = jax.lax.dot_general(
            tri, pl, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32
        ).reshape(chunk, nchunks, planes.shape[-1])
    else:
        inner = jax.lax.dot_general(
            tri, planes, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)  # (chunk, nchunks, P*F)
    inner = jnp.moveaxis(inner, 0, 1).astype(jnp.int32)
    if two_planes:
        inner = (inner[..., :f]
                 + (inner[..., f:] << 8) - (counts << 15))
    else:
        inner = inner - (counts << 7)
    totals = inner[:, -1]
    offsets = jnp.cumsum(totals, axis=0, dtype=jnp.int32) - totals
    out = inner + offsets[:, None]
    return out.reshape(-1, *trailing)[:n] if trailing else out.reshape(-1)[:n]


def delta_decode(errs_zz: jnp.ndarray, elem_bits: int) -> jnp.ndarray:
    """Inverse of delta_encode: one big (hierarchical) prefix sum over rows."""
    deltas = zigzag_decode(errs_zz, elem_bits)
    return hierarchical_cumsum(deltas, value_bits=elem_bits) & ((1 << elem_bits) - 1)


def hierarchical_cumsum_last(x: jnp.ndarray, chunk: int = 256,
                             value_bits: int = 16) -> jnp.ndarray:
    """Two-level inclusive prefix sum along the LAST axis of (..., N).

    Same exact-integer plane decomposition as ``hierarchical_cumsum``
    (which scans axis 0), but for the dim-major lowdim layout (D, N):
    there the sample axis is minor, so every tensor in this formulation
    keeps a >= chunk minor dimension (the axis-0 form on (N, 4) has a
    minor dim of 4). Preconditions as hierarchical_cumsum.
    """
    n = x.shape[-1]
    if n <= chunk:
        return jnp.cumsum(x, axis=-1, dtype=jnp.int32)
    pad = (-n) % chunk
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
    c = xp.reshape(*x.shape[:-1], -1, chunk)  # (..., nchunks, chunk)
    counts = jnp.arange(chunk, dtype=jnp.int32) + 1  # broadcast on last axis
    two_planes = value_bits > 8
    # M[k, i] = 1 iff k <= i: contracting the chunk axis with M gives the
    # inclusive prefix along the last axis.
    if PREFIX_IMPL == "s8":
        m = jnp.triu(jnp.ones((chunk, chunk), jnp.int8))

        def pdot(p):
            return jax.lax.dot_general(
                p, m, dimension_numbers=(((p.ndim - 1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32)

        if two_planes:
            lo = pdot(((c & 0xFF) - 128).astype(jnp.int8))
            hi = pdot((c >> 8).astype(jnp.int8))
            inner = lo + (counts << 7) + (hi << 8)
        else:
            inner = pdot(c.astype(jnp.int8))
    else:
        m = jnp.triu(jnp.ones((chunk, chunk), jnp.bfloat16))

        def pdot(p):
            return jax.lax.dot_general(
                p, m, dimension_numbers=(((p.ndim - 1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32).astype(jnp.int32)

        if two_planes:
            lo = pdot((c & 0xFF).astype(jnp.bfloat16))
            hi = pdot(((c >> 8) + 128).astype(jnp.bfloat16))
            inner = lo + (hi << 8) - (counts << 15)
        else:
            inner = pdot((c + 128).astype(jnp.bfloat16)) - (counts << 7)
    totals = inner[..., -1]
    offsets = jnp.cumsum(totals, axis=-1, dtype=jnp.int32) - totals
    out = inner + offsets[..., None]
    return out.reshape(*x.shape[:-1], -1)[..., :n]


# ------------------------------------------------------------------ FIRE


def _fire_coef(counter: jnp.ndarray, elem_bits: int, truncate_coeffs: bool,
               learning_shift: int = FIRE_LEARNING_SHIFT) -> jnp.ndarray:
    if truncate_coeffs:
        shft = elem_bits - 4
        coef = (counter >> (learning_shift + shft)) << shft
        return sign_extend(coef, 16)  # int16_t coef (sprintz_xff_rle.cpp:221)
    return counter >> learning_shift  # full precision (lowdim variant)


def _counter_bits(elem_bits: int) -> int:
    return 16 if elem_bits == 8 else 32


def _fire_block_step(carry, block_vals, *, elem_bits, truncate_coeffs, decode,
                     learning_shift=FIRE_LEARNING_SHIFT, transform=False):
    """One 8-row FIRE step, vectorized over lanes.

    carry: (prev_val, prev_delta, counter) int32 lane arrays.
    block_vals: (8, ...) int32 — raw values (encode) or zigzag errs (decode).
    Returns (new_carry, (8, ...) int32 output — errs (encode) or vals).

    ``transform=True`` selects the standalone-preprocessor variant
    (predict.cpp:56-300, VERDICT r3 item 8): raw (non-zigzag) errors,
    divergent learning_shift (1 for u8, 3 for u16 — predict.cpp:62), and
    the SIMD kernel's exact prediction quirks — u8 even-index dims
    multiply the ZERO-extended previous delta (the `_mm256_and_si256(
    prev_deltas, low_mask)` even-byte path, predict.cpp:160-169) while
    odd dims sign-extend; u16 predictions are `mulhi << 2`
    (predict.cpp:233-235), unlike the codec's plain `>> 16`.
    """
    prev_val, prev_delta, counter = carry
    coef = _fire_coef(counter, elem_bits, truncate_coeffs, learning_shift)
    grad_sum = jnp.zeros_like(prev_delta)
    if transform and elem_bits == 8:
        # dim-parity mask along the lane (dims) axis
        even = (jnp.arange(prev_delta.shape[-1]) % 2) == 0
    outs = []
    for i in range(BLOCK_SZ):
        if transform and elem_bits == 8:
            pd = jnp.where(even, prev_delta & 0xFF, prev_delta)
            prediction = sign_extend((pd * coef) >> 8, 8)
        elif transform:
            prediction = sign_extend(((prev_delta * coef) >> 16) << 2, 16)
        else:
            prediction = sign_extend(
                (prev_delta * coef) >> elem_bits, elem_bits)
        if decode:
            err = (block_vals[i] if transform
                   else zigzag_decode(block_vals[i], elem_bits))
            delta = sign_extend(err + prediction, elem_bits)
            val = (prev_val + delta) & ((1 << elem_bits) - 1)
            outs.append(val)
        else:
            val = block_vals[i]
            delta = sign_extend(val - prev_val, elem_bits)
            err = sign_extend(delta - prediction, elem_bits)
            outs.append(err if transform
                        else zigzag_encode(err, elem_bits))
        if i % 2 == 1:  # learning_downsample == 2
            # icopysign(err, prev_delta) (util.h:63-74)
            mask = err >> 31
            grad = jnp.where(err != 0, (prev_delta ^ mask) - mask, 0)
            grad_sum = sign_extend(grad_sum + grad, elem_bits)
        prev_val = val
        prev_delta = delta
    counter = sign_extend(counter + (grad_sum >> 2), _counter_bits(elem_bits))
    return (prev_val, prev_delta, counter), jnp.stack(outs)


def _fire_scan(vals_or_errs: jnp.ndarray, elem_bits: int,
               truncate_coeffs: bool, decode: bool,
               init_state=None, return_states: bool = False,
               return_final: bool = False,
               learning_shift: int = FIRE_LEARNING_SHIFT,
               transform: bool = False):
    """Scan FIRE over blocks. Input (nb, 8, ...) int32; output same shape.

    ``init_state``: optional (prev_val, prev_delta, counter) carry — the
    ``jump()`` analogue (online.hpp:126-132) enabling mid-stream entry.
    ``return_states``: also return the carry BEFORE each block (nb, 3, ...),
    for sidecar/checkpoint capture.
    ``return_final``: also return the carry AFTER the last block — the
    boundary state handed to the next chunk/shard (parallel/shard.py).
    """
    # zeros derived from the input so the carry inherits any mesh-varying
    # axes when running under shard_map (scan carry types must match)
    zero = jnp.zeros_like(vals_or_errs[0, 0])
    carry0 = (zero, zero, zero) if init_state is None else tuple(
        jnp.asarray(s, jnp.int32) + zero for s in init_state)
    step = functools.partial(
        _fire_block_step, elem_bits=elem_bits,
        truncate_coeffs=truncate_coeffs, decode=decode,
        learning_shift=learning_shift, transform=transform)
    if return_states:
        def step_with_state(carry, block):
            new_carry, out = step(carry, block)
            return new_carry, (out, jnp.stack(carry))

        final, (out, states) = jax.lax.scan(
            step_with_state, carry0, vals_or_errs, unroll=SCAN_UNROLL)
        return (out, states, final) if return_final else (out, states)
    # unroll amortizes per-step scan overhead over 8 blocks (the carry
    # chain is the only sequential dependency)
    final, out = jax.lax.scan(step, carry0, vals_or_errs,
                              unroll=SCAN_UNROLL)
    return (out, final) if return_final else out


def fire_encode(rows: jnp.ndarray, elem_bits: int,
                truncate_coeffs: bool = True) -> jnp.ndarray:
    """rows: (N, D) int32 unsigned values, N divisible by 8 -> zigzag errs."""
    nb = rows.shape[0] // BLOCK_SZ
    blocks = rows.reshape(nb, BLOCK_SZ, *rows.shape[1:])
    return _fire_scan(blocks, elem_bits, truncate_coeffs, decode=False
                      ).reshape(rows.shape)


def fire_encode_with_states(rows: jnp.ndarray, elem_bits: int,
                            truncate_coeffs: bool = True):
    """Like fire_encode, also returning the (nb, 3, D) carry before each
    block (prev_val, prev_delta, counter) for checkpoint sidecars."""
    nb = rows.shape[0] // BLOCK_SZ
    blocks = rows.reshape(nb, BLOCK_SZ, *rows.shape[1:])
    out, states = _fire_scan(blocks, elem_bits, truncate_coeffs,
                             decode=False, return_states=True)
    return out.reshape(rows.shape), states


def fire_decode(errs_zz: jnp.ndarray, elem_bits: int,
                truncate_coeffs: bool = True,
                init_state=None) -> jnp.ndarray:
    """errs_zz: (N, D) int32 zigzag errors -> unsigned values (N, D) int32."""
    nb = errs_zz.shape[0] // BLOCK_SZ
    blocks = errs_zz.reshape(nb, BLOCK_SZ, *errs_zz.shape[1:])
    return _fire_scan(blocks, elem_bits, truncate_coeffs, decode=True,
                      init_state=init_state).reshape(errs_zz.shape)


def fire_decode_chunk(errs_zz: jnp.ndarray, elem_bits: int,
                      truncate_coeffs: bool = True, init_state=None):
    """fire_decode that also returns the final (prev_val, prev_delta,
    counter) carry, for chunked/tiled decode of long streams."""
    nb = errs_zz.shape[0] // BLOCK_SZ
    blocks = errs_zz.reshape(nb, BLOCK_SZ, *errs_zz.shape[1:])
    out, final = _fire_scan(blocks, elem_bits, truncate_coeffs, decode=True,
                            init_state=init_state, return_final=True)
    return out.reshape(errs_zz.shape), jnp.stack(final)
