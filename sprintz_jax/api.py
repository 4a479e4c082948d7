"""Public API: compress/decompress entry points with ndims dispatch.

Mirrors the reference's 8 public entry points (sprintz.h:16-32) as a single
codec object parameterized on (forecaster, element size). The reference
dispatches ndims 1-4 (u8) / 1-2 (u16) to column-major "lowdim" variants and
everything else to the general row-major codec (sprintz.cpp:34-74); this
module reproduces that dispatch so streams stay byte-compatible.

Backends:
- ``backend="auto"`` (default) and ``backend="jax"``: the vectorized JAX
  path (device pass + native host stages). A JAX that cannot be imported
  is an error, never a silent switch to the scalar codec.
- ``backend="golden"``: scalar numpy spec codec (the executable format
  spec and test oracle).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import LOWDIM_MAX_NDIMS
from .errors import CorruptStreamError
from .golden import rowmajor as _golden_rowmajor
from .golden import lowdim as _golden_lowdim

_BACKENDS = ("auto", "jax", "golden")

__all__ = ["CorruptStreamError", "SprintzCodec", "compress", "decompress"]


@dataclasses.dataclass(frozen=True)
class SprintzCodec:
    """A configured Sprintz codec.

    Args:
      codec: "delta" (running difference) or "xff" (FIRE online forecaster).
      elem_sz: bytes per element: 1 (uint8) or 2 (uint16).
      backend: "auto" (= "jax"), "jax", or "golden".
    """

    codec: str = "delta"
    elem_sz: int = 1
    backend: str = "auto"
    entropy: str = "none"  # "none" | "huffman" (the paper's "+Huf" variants)

    def __post_init__(self):
        if self.codec not in ("delta", "xff"):
            raise ValueError(f"codec must be 'delta' or 'xff', got {self.codec!r}")
        if self.elem_sz not in (1, 2):
            raise ValueError(f"elem_sz must be 1 or 2, got {self.elem_sz}")
        if self.entropy not in ("none", "huffman"):
            raise ValueError(f"unknown entropy stage {self.entropy!r}")
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"backend must be one of {_BACKENDS}, got {self.backend!r}")

    # ------------------------------------------------------------- helpers
    def _use_lowdim(self, ndims: int) -> bool:
        return ndims <= LOWDIM_MAX_NDIMS[self.elem_sz]

    def _as_flat(self, data: np.ndarray) -> tuple[np.ndarray, int]:
        udt = np.uint8 if self.elem_sz == 1 else np.uint16
        data = np.ascontiguousarray(data)
        if data.dtype != udt:
            raise TypeError(f"expected dtype {udt}, got {data.dtype}")
        if data.ndim == 2:
            return data.reshape(-1), data.shape[1]
        if data.ndim == 1:
            return data, 1
        raise ValueError("data must be 1-D (univariate) or 2-D (rows, dims)")

    # ------------------------------------------------------------- API
    def compress(self, data: np.ndarray, ndims: int | None = None) -> bytes:
        """Compress a (rows, ndims) array or flat row-major stream."""
        stream = self._compress_sprintz(data, ndims)
        if self.entropy == "huffman":
            return self._entropy_wrap(stream)
        return stream

    @staticmethod
    def _entropy_wrap(stream: bytes) -> bytes:
        """+Huf entropy stage with a ZERO-overhead stored escape: when
        Huffman coding does not shrink the stream, the plain sprintz
        stream is emitted verbatim (decompress routes on the strict
        huffman-container check, entropy/huffman.py:is_container), so
        +Huf never loses a single byte to plain sprintz. A plain stream
        that would itself misparse as a container (astronomically rare)
        gets the deterministic 12-byte stored wrapper instead."""
        from .entropy import huff_compress
        from .entropy.huffman import is_container

        coded = huff_compress(stream)
        if len(coded) >= len(stream) and not is_container(stream):
            return stream
        return coded

    def _compress_sprintz(self, data: np.ndarray, ndims: int | None) -> bytes:
        flat, inferred = self._as_flat(data)
        ndims = inferred if ndims is None else ndims
        if self.backend != "golden":
            from . import encoder as _jax_encoder

            return _jax_encoder.compress(
                flat, ndims, codec=self.codec, elem_sz=self.elem_sz)
        if self._use_lowdim(ndims):
            return _golden_lowdim.compress_lowdim_rle(flat, ndims, codec=self.codec)
        return _golden_rowmajor.compress_rowmajor_rle(flat, ndims, codec=self.codec)

    def compress_seekable(self, data: np.ndarray, ndims: int | None = None,
                          every_groups: int = 16):
        """Compress + build a checkpoint sidecar (checkpoint.py).

        Returns (stream, sidecar). The stream is byte-identical to
        ``compress``; the sidecar enables ``decode_range`` seeks and
        chunk-parallel decode (pass it back to ``decompress``)."""
        flat, inferred = self._as_flat(data)
        ndims = inferred if ndims is None else ndims
        from .checkpoint import compress_with_sidecar

        stream, sc = compress_with_sidecar(
            flat, ndims, codec=self.codec, every_groups=every_groups)
        if self.entropy == "huffman":
            stream = self._entropy_wrap(stream)
        return stream, sc

    def compress_batch(self, arrays: list[np.ndarray],
                       ndims: int | None = None) -> list[bytes]:
        """Compress S same-ndims arrays in one device pass (encoder
        forecast/pack runs S*D lanes wide — the throughput axis for
        fleets of small streams). Streams are byte-identical to
        per-stream ``compress``."""
        same_shape = (arrays and all(
            np.asarray(a).ndim == 2 and a.shape == arrays[0].shape
            for a in arrays))
        # the batched fast path infers elem_sz from the array dtype, so
        # it must match the codec's configured width — otherwise fall
        # through to per-stream compress, whose _as_flat raises the
        # same TypeError the single-stream API would (ADVICE r3)
        expected = np.dtype(np.uint8 if self.elem_sz == 1 else np.uint16)
        if (self.backend != "golden" and self.entropy == "none"
                and ndims is None and same_shape
                and np.asarray(arrays[0]).dtype == expected):
            from . import encoder as _jax_encoder

            return _jax_encoder.compress_batch(
                np.stack(arrays), codec=self.codec)
        return [self.compress(a, ndims=ndims) for a in arrays]

    def decompress_batch(self, bufs: list[bytes]) -> list[np.ndarray]:
        """Decompress S same-ndims streams in one vmapped device pass
        (counterpart of ``compress_batch``)."""
        if self.backend != "golden" and self.entropy == "none":
            from . import decoder as _jax_decoder

            return _jax_decoder.decompress_batch(
                bufs, codec=self.codec, elem_sz=self.elem_sz)
        return [self.decompress(b) for b in bufs]

    def decompress(self, buf: bytes, sidecar=None) -> np.ndarray:
        """Decompress a stream; returns the flat row-major element array.

        ``sidecar``: optional checkpoint sidecar from
        ``compress_seekable`` — decodes chunk-parallel (every chunk
        enters at its recorded forecaster state), the fast path for
        long FIRE streams on the jax backend.

        Raises ``CorruptStreamError`` when the buffer is truncated or its
        metadata is inconsistent (the format itself carries no checksums,
        matching the reference)."""
        if self.entropy == "huffman":
            from .entropy import huff_decompress
            from .entropy.huffman import is_container

            if is_container(buf):
                buf = huff_decompress(buf).tobytes()
            # else: zero-overhead stored escape — plain sprintz verbatim
        if sidecar is not None and self.backend != "golden":
            from .checkpoint import decompress_parallel

            return decompress_parallel(buf, sidecar)
        if len(buf) < 8:
            raise CorruptStreamError(
                f"stream shorter than its 8-byte metadata ({len(buf)} bytes)")
        ngroups, remaining_len, ndims = _golden_rowmajor.read_metadata_rle(buf)
        if ndims == 0 and not (ngroups == 0 and remaining_len == 0):
            raise CorruptStreamError("metadata declares 0 dims")
        min_len = 8 + remaining_len * self.elem_sz
        if len(buf) < min_len:
            raise CorruptStreamError(
                f"stream truncated: {len(buf)} bytes < minimum {min_len} "
                f"implied by metadata")
        if self.backend != "golden":
            from . import decoder as _jax_decoder

            return _jax_decoder.decompress(
                buf, codec=self.codec, elem_sz=self.elem_sz)
        if ndims and self._use_lowdim(ndims) and not (
                ngroups == 0 and remaining_len < _golden_rowmajor.MIN_DATA_SIZE):
            return _golden_lowdim.decompress_lowdim_rle(
                buf, codec=self.codec, elem_sz=self.elem_sz)
        return _golden_rowmajor.decompress_rowmajor_rle(
            buf, codec=self.codec, elem_sz=self.elem_sz)


def compress(
    data: np.ndarray,
    codec: str = "delta",
    ndims: int | None = None,
    backend: str = "auto",
) -> bytes:
    elem_sz = np.asarray(data).dtype.itemsize
    return SprintzCodec(codec, elem_sz, backend).compress(data, ndims=ndims)


def decompress(
    buf: bytes,
    codec: str = "delta",
    elem_sz: int = 1,
    backend: str = "auto",
) -> np.ndarray:
    return SprintzCodec(codec, elem_sz, backend).decompress(buf)
