"""JAX bit-math primitives: zigzag, bit widths, header field mapping.

Vectorized replacements for the reference's scalar LUTs and AVX2 shuffles
(bitpack.h:43-186, :302-358): lookup tables become branch-free
elementwise arithmetic (comparisons vectorize).
"""

from __future__ import annotations

import jax.numpy as jnp


def zigzag_encode(x: jnp.ndarray, elem_bits: int) -> jnp.ndarray:
    """Signed err -> unsigned zigzag, computed in int32 lanes.

    Input values must be sign-extended int32 in [-2^(eb-1), 2^(eb-1)).
    Returns int32 in [0, 2^eb).
    """
    return ((x << 1) ^ (x >> 31)) & ((1 << elem_bits) - 1)


def zigzag_decode(u: jnp.ndarray, elem_bits: int) -> jnp.ndarray:
    """Unsigned zigzag (int32 lanes) -> sign-extended int32."""
    val = (u >> 1) ^ -(u & 1)
    return sign_extend(val, elem_bits)


def sign_extend(x: jnp.ndarray, elem_bits: int) -> jnp.ndarray:
    """Reinterpret the low elem_bits of int32 lanes as signed."""
    shift = 32 - elem_bits
    return (x << shift) >> shift


def bit_length(x: jnp.ndarray, max_bits: int) -> jnp.ndarray:
    """Per-lane bit length (position of highest set bit + 1) of uint values.

    Branch-free: counts thresholds 2^k <= x. Exact for x < 2^max_bits.
    """
    x = x.astype(jnp.int32)
    width = jnp.zeros_like(x)
    for k in range(max_bits):
        width = width + (x >= (1 << k)).astype(jnp.int32)
    return width


def block_widths_rowmajor(ormask: jnp.ndarray, elem_sz: int) -> jnp.ndarray:
    """Row-major per-dim width from the OR of a block's zigzag values.

    8b: legal widths {0..6, 8}: 7 promotes to 8 (bitpack.h:72).
    16b: if any high bit is set, the low byte is kept in full:
    width = 8 + promote7(bitlen(hi)); else promote7(bitlen(lo))
    (sprintz_delta_rle.cpp:177-187).
    """
    if elem_sz == 1:
        w = bit_length(ormask, 8)
        return w + (w == 7)
    hi = ormask >> 8
    lo = ormask & 0xFF
    whi = bit_length(hi, 8)
    whi = whi + (whi == 7)
    wlo = bit_length(lo, 8)
    wlo = wlo + (wlo == 7)
    return jnp.where(hi > 0, 8 + whi, wlo)


def block_widths_lowdim(ormask: jnp.ndarray, elem_sz: int) -> jnp.ndarray:
    """Lowdim width: raw bit length with only (eb-1) -> eb promotion
    (sprintz_delta_lowdim.cpp:176-177)."""
    eb = 8 * elem_sz
    w = bit_length(ormask, eb)
    return w + (w == eb - 1)


def header_value(widths: jnp.ndarray, elem_bits: int) -> jnp.ndarray:
    """Stored header field: width, with elem_bits mapped to elem_bits-1
    (sprintz_delta_rle.cpp:199)."""
    return widths - (widths == elem_bits)


def header_to_width(h: jnp.ndarray, elem_bits: int) -> jnp.ndarray:
    """Decoder mapping: elem_bits-1 -> elem_bits (sprintz_delta.cpp:563-566)."""
    return h + (h == elem_bits - 1)
