"""Dataset layer: quantization semantics, binary layout IO, profiles."""

import numpy as np

from sprintz_jax.data import (
    CORPUS_PROFILES,
    load_dataset,
    quantize,
    read_dat,
    synthetic_corpus,
    write_dat,
)


def test_quantize_full_range(rng):
    mat = rng.normal(0, 10, (1000, 4))
    q8 = quantize(mat, np.uint8)
    assert q8.dtype == np.uint8
    assert q8.min() == 0 and q8.max() == 255
    q16 = quantize(mat, np.uint16)
    assert q16.max() == 65535
    # monotone per column
    col = np.argsort(mat[:, 0])
    assert (np.diff(q8[col, 0].astype(int)) >= 0).all()


def test_dat_layout_roundtrip(tmp_path, rng):
    mat = rng.integers(0, 256, (500, 8)).astype(np.uint8)
    p = write_dat(tmp_path, "foo", mat, order="c")
    assert "rowmajor/uint8" in str(p)
    back = read_dat(p, np.uint8, ndims=8)
    np.testing.assert_array_equal(back, mat)


def test_synthetic_profiles_compressible():
    from sprintz_jax import encoder

    for name, prof in CORPUS_PROFILES.items():
        mat = synthetic_corpus(name, nrows=4000)
        assert mat.shape == (4000, prof["ndims"])
        buf = encoder.compress(mat.reshape(-1), prof["ndims"], codec="delta")
        # all profiles are time-series-like: delta must beat raw
        assert len(buf) < mat.nbytes, name


def test_load_dataset_fallback():
    mat = load_dataset("ucr_like", nrows=2000)
    assert mat.shape == (2000, 1)
