"""Checked-in golden stream vectors: byte-exactness without the oracle lib.

The fixtures under tests/vectors/ were generated by the compiled reference
implementation (see tests/oracle.py); these tests pin the stream format
even in environments that cannot build the reference.
"""

import json
import pathlib

import numpy as np
import pytest

from sprintz_jax import decoder, encoder
from sprintz_jax.golden.lowdim import compress_lowdim_rle
from sprintz_jax.golden.rowmajor import compress_rowmajor_rle

VEC = pathlib.Path(__file__).parent / "vectors"
MANIFEST = json.loads((VEC / "manifest.json").read_text())


@pytest.mark.parametrize("case", MANIFEST, ids=[c["name"] for c in MANIFEST])
def test_golden_vector(case):
    dt = np.uint8 if case["elem_sz"] == 1 else np.uint16
    x = np.frombuffer((VEC / f"{case['name']}.in").read_bytes(), dtype=dt)
    expected = (VEC / f"{case['name']}.sprintz").read_bytes()
    ndims = case["ndims"]
    # jax encoder
    assert encoder.compress(x, ndims, codec=case["codec"]) == expected
    # golden encoder
    lowdim = ndims <= (4 if case["elem_sz"] == 1 else 2)
    golden = (compress_lowdim_rle if lowdim else compress_rowmajor_rle)(
        x, ndims, codec=case["codec"])
    assert golden == expected
    # decode the reference bytes
    dec = decoder.decompress(expected, codec=case["codec"],
                             elem_sz=case["elem_sz"])
    np.testing.assert_array_equal(dec, x)
