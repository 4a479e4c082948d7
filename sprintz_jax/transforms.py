"""Standalone preprocessor transforms: delta / doubledelta / xff rowmajor.

Parity targets: the reference's unpacked transform
entry points in delta.cpp (encode/decode_delta_rowmajor_{8,16}b,
encode/decode_doubledelta_rowmajor_{8,16}b, + the _inplace variants) and
predict.cpp (encode/decode_xff_rowmajor_{8,16}b + _inplace). These are
NOT the sprintz codecs: output is the same length as the input (errors
stored raw at full element width, no bit packing, no zigzag), prefixed
by the 6-byte {u32 len, u16 ndims} simple header when ``write_size``.

Semantics reproduced bit-for-bit (oracle-tested):
- delta (delta.cpp:34-120): out[j] = src[j] - src[j-D] (first row copied).
- doubledelta (delta.cpp:406-467): second difference at lag D — the
  delta transform applied twice.
- xff (predict.cpp:56-300): FIRE-coded for the leading ``nblocks`` 8-row
  blocks (with the preprocessor's divergent learning_shift = 1/3 for
  u8/u16 and the SIMD kernel's exact prediction quirks — see
  models/forecasters._fire_block_step(transform=True)), then plain
  lag-D delta for the trailing elements; nblocks is clipped by the
  reference's overrun guard (predict.cpp:102-107) so the vectorized
  kernel never writes past the buffer.

Formulation: delta/doubledelta are pure shifted subtracts
(vectorized numpy on host; trivially jittable); the xff head runs the
same lane-parallel FIRE block scan the codec uses (lax.scan over blocks,
dims in lanes).
"""

from __future__ import annotations

import numpy as np

from .constants import BLOCK_SZ
from .golden.stream import read_metadata_simple, write_metadata_simple

_VECTOR_NBYTES = 32  # AVX2 vector the reference's overrun guard assumes

KINDS = ("delta", "doubledelta", "xff")


def _check(kind: str, dtype) -> int:
    if kind not in KINDS:
        raise ValueError(f"unknown transform kind {kind!r}")
    elem_sz = np.dtype(dtype).itemsize
    if np.dtype(dtype).kind != "u" or elem_sz not in (1, 2):
        raise TypeError(f"transforms take uint8/uint16 data, got {dtype}")
    return elem_sz


def _lag_delta(flat: np.ndarray, ndims: int) -> np.ndarray:
    """out[j] = src[j] - src[j-D] (wrapping), first D elements copied."""
    out = flat.copy()
    if flat.size > ndims:
        out[ndims:] = flat[ndims:] - flat[:-ndims]
    return out


def _lag_undelta(errs: np.ndarray, ndims: int, base: np.ndarray | None
                 ) -> np.ndarray:
    """Inverse of _lag_delta: per-dim wrapping prefix sum.

    ``base``: the D reconstructed values preceding the first error row
    (None = stream start, i.e. the first row is stored verbatim).
    """
    n = errs.size
    if n == 0:
        return errs.copy()
    nrows = -(-n // ndims)
    pad = np.zeros(nrows * ndims, errs.dtype)
    pad[:n] = errs
    grid = pad.reshape(nrows, ndims)
    # wrapping addition is associative, so a wide cumsum taken mod 2^eb
    # equals the serial wrapping sum
    acc = np.cumsum(grid.astype(np.uint64), axis=0)
    if base is not None:
        acc += base.astype(np.uint64)[None, :]
    return acc.astype(errs.dtype).reshape(-1)[:n]


# ------------------------------------------------------------------ xff


def _xff_nblocks(n: int, ndims: int, elem_sz: int) -> int:
    """The reference's overrun guard (predict.cpp:102-107): FIRE-code
    only blocks whose trailing vector overrun stays inside the buffer."""
    vector_sz = _VECTOR_NBYTES // elem_sz
    nblocks = (n // ndims) // BLOCK_SZ
    overrun = vector_sz - (ndims % vector_sz)
    trailing = n % (BLOCK_SZ * ndims)
    if overrun > trailing:
        nblocks -= -(-overrun // (BLOCK_SZ * ndims))
        nblocks = max(0, nblocks)
    return nblocks


def _xff_fire(rows_u: np.ndarray, elem_sz: int, decode: bool) -> np.ndarray:
    """Run the preprocessor-variant FIRE over (N, D) rows (N % 8 == 0)."""
    import jax.numpy as jnp

    from .models.forecasters import _fire_scan

    eb = 8 * elem_sz
    learning_shift = 1 if elem_sz == 1 else 3  # predict.cpp:62
    n, ndims = rows_u.shape
    if decode:
        sdt = np.int8 if elem_sz == 1 else np.int16
        vals = rows_u.view(sdt).astype(np.int32)
    else:
        vals = rows_u.astype(np.int32)
    blocks = jnp.asarray(vals).reshape(n // BLOCK_SZ, BLOCK_SZ, ndims)
    out = _fire_scan(blocks, eb, truncate_coeffs=True, decode=decode,
                     learning_shift=learning_shift, transform=True)
    return np.asarray(out).reshape(n, ndims)


def _xff_encode_flat(flat: np.ndarray, ndims: int) -> np.ndarray:
    elem_sz = flat.dtype.itemsize
    nblocks = _xff_nblocks(flat.size, ndims, elem_sz)
    head = nblocks * BLOCK_SZ * ndims
    out = flat.copy()
    if head:
        errs = _xff_fire(flat[:head].reshape(-1, ndims), elem_sz,
                         decode=False)
        out[:head] = (errs & ((1 << (8 * elem_sz)) - 1)).astype(
            flat.dtype).reshape(-1)
        if flat.size > head:  # trailing elements: plain lag-D delta
            out[head:] = flat[head:] - flat[head - ndims: flat.size - ndims]
    else:
        out = _lag_delta(flat, ndims)
    return out


def _xff_decode_flat(errs: np.ndarray, ndims: int) -> np.ndarray:
    elem_sz = errs.dtype.itemsize
    n = errs.size
    nblocks = _xff_nblocks(n, ndims, elem_sz)
    head = nblocks * BLOCK_SZ * ndims
    out = np.empty(n, errs.dtype)
    if head:
        vals = _xff_fire(errs[:head].reshape(-1, ndims), elem_sz,
                         decode=True)
        out[:head] = vals.astype(errs.dtype).reshape(-1)
        if n > head:
            out[head:] = _lag_undelta(errs[head:], ndims,
                                      out[head - ndims: head])
    else:
        out = _lag_undelta(errs, ndims, None)
    return out


# ------------------------------------------------------------------ API


def transform_encode(data: np.ndarray, kind: str, ndims: int | None = None,
                     write_size: bool = True) -> bytes:
    """Encode with a standalone transform; output bytes match the
    reference's encode_{kind}_rowmajor_{8,16}b exactly."""
    data = np.ascontiguousarray(data)
    elem_sz = _check(kind, data.dtype)
    if data.ndim == 2:
        ndims = data.shape[1] if ndims is None else ndims
    elif ndims is None:
        ndims = 1
    flat = data.reshape(-1)
    if kind == "delta":
        body = _lag_delta(flat, ndims)
    elif kind == "doubledelta":
        body = _lag_delta(_lag_delta(flat, ndims), ndims)
    else:
        body = _xff_encode_flat(flat, ndims)
    head = write_metadata_simple(flat.size, ndims) if write_size else b""
    return head + body.tobytes()


def transform_decode(buf: bytes, kind: str, elem_sz: int,
                     ndims: int | None = None,
                     n: int | None = None) -> np.ndarray:
    """Decode a transform_encode stream. With ndims/n omitted, reads the
    6-byte header (the reference's (src, dest) overloads); pass both to
    decode a headerless body (the (src, len, dest, ndims) overloads)."""
    _check(kind, np.uint8 if elem_sz == 1 else np.uint16)
    udt = np.uint8 if elem_sz == 1 else np.uint16
    if ndims is None or n is None:
        n, ndims = read_metadata_simple(buf)
        buf = buf[6:]
    errs = np.frombuffer(buf, dtype=udt, count=n)
    if kind == "delta":
        return _lag_undelta(errs, ndims, None)
    if kind == "doubledelta":
        return _lag_undelta(_lag_undelta(errs, ndims, None), ndims, None)
    return _xff_decode_flat(errs, ndims)


def transform_decode_inplace(buff: np.ndarray, n: int, ndims: int,
                             kind: str) -> np.ndarray:
    """decode_{kind}_rowmajor_inplace_{8,16}b: the first n elements of
    ``buff`` hold transform output; they are replaced with the decoded
    values (returned as a view of buff)."""
    elem_sz = _check(kind, buff.dtype)
    out = transform_decode(buff[:n].tobytes(), kind, elem_sz,
                           ndims=ndims, n=n)
    buff[:n] = out
    return buff[:n]
