"""Format constants for the Sprintz-JAX stream format.

The on-disk stream format is byte-compatible with the reference sprintz
implementation (see /root/reference/cpp/Compress). Constant provenance:

- ``BLOCK_SZ``/``GROUP_SZ_BLOCKS``/``STRIPE_SZ_NBYTES``: sprintz_delta.cpp:73,48,74
- header field width 3/4 bits: sprintz_delta.cpp:71
- ``MAX_RUN_NBLOCKS`` (15-bit run counter): sprintz_delta_rle.cpp:68
- min compressible size (below which streams are stored verbatim):
  sprintz_delta_rle.cpp:71,101-109
- metadata layouts: format.h:31-33
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Samples (rows) per block. 8 rows x w bits always lands on a byte boundary.
BLOCK_SZ = 8
LOG2_BLOCK_SZ = 3

# Blocks per group: one group header region covers this many blocks.
GROUP_SZ_BLOCKS = 2

# A "stripe" is 8 bytes of a row: 8 dims at 8 bits, 4 dims at 16 bits.
STRIPE_SZ_NBYTES = 8

# Zero-run length cap: lengths are coded as a 7/15-bit varint.
MAX_RUN_NBLOCKS = 0x7FFF

# Streams shorter than this many elements are stored verbatim (ngroups == 0).
MIN_DATA_SIZE = 8 * BLOCK_SZ * GROUP_SZ_BLOCKS  # == 128 elements

# Stream metadata layouts (format.h:31-33).
METADATA_LEN_RLE = 8  # {u32 ngroups, u16 remaining_len, u16 ndims}, little-endian
METADATA_LEN_SIMPLE = 6  # {u32 len, u16 ndims}
METADATA_LEN_SIMPLE_1D = 4  # {u32 len}

# FIRE (xff) hyperparameters (sprintz_xff_rle.cpp:74-76).
FIRE_LEARNING_SHIFT = 1
FIRE_LOG2_LEARNING_DOWNSAMPLE = 1
FIRE_LEARNING_DOWNSAMPLE = 1 << FIRE_LOG2_LEARNING_DOWNSAMPLE

# Max dims handled by the column-major low-dimensional variants
# (sprintz_delta_lowdim.cpp:64-70): sample row must fit in 32 bits.
LOWDIM_MAX_NDIMS = {1: 4, 2: 2}  # elem_sz -> max ndims


def nbits_sz_bits(elem_sz: int) -> int:
    """Width of one per-dim bitwidth header field: 3 bits (u8), 4 bits (u16)."""
    return 3 if elem_sz == 1 else 4


def stripe_sz(elem_sz: int) -> int:
    """Dims per 8-byte stripe."""
    return STRIPE_SZ_NBYTES // elem_sz


def _build_nbits_mask_u8() -> np.ndarray:
    """Map an OR-of-zigzag-values byte to its data mask.

    Legal 8-bit field widths are {0..6, 8}: a 7-bit value is promoted to a
    full byte, so both 7- and 8-bit ORs map to 0xff (bitpack.h:72).
    """
    table = np.empty(256, dtype=np.uint8)
    for v in range(256):
        width = v.bit_length()
        if width == 7:
            width = 8
        table[v] = (1 << width) - 1
    return table


NBITS_MASKS_U8 = _build_nbits_mask_u8()


def uint_dtype(elem_sz: int) -> np.dtype:
    return np.dtype(np.uint8 if elem_sz == 1 else np.uint16)


def int_dtype(elem_sz: int) -> np.dtype:
    return np.dtype(np.int8 if elem_sz == 1 else np.int16)


def counter_dtype(elem_sz: int) -> np.dtype:
    """FIRE coefficient accumulator: i16 for u8 data, i32 for u16 (util.h:39-47)."""
    return np.dtype(np.int16 if elem_sz == 1 else np.int32)


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Runtime-configurable knobs; defaults replicate the reference format.

    Changing any field gives a self-consistent but non-reference-compatible
    stream (the reference hardcodes all of these at compile time).
    """

    block_sz: int = BLOCK_SZ
    group_sz_blocks: int = GROUP_SZ_BLOCKS
    max_run_nblocks: int = MAX_RUN_NBLOCKS
    fire_learning_shift: int = FIRE_LEARNING_SHIFT
    fire_log2_learning_downsample: int = FIRE_LOG2_LEARNING_DOWNSAMPLE

    @property
    def min_data_size(self) -> int:
        return 8 * self.block_sz * self.group_sz_blocks


DEFAULT_CONFIG = CodecConfig()
