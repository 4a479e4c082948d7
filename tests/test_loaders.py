"""Real-format corpus parsers over the checked-in miniature corpus:
parse -> quantize -> compress -> oracle byte parity, end to end."""

import pathlib

import numpy as np
import pytest

from sprintz_jax import api
from sprintz_jax.data import loaders
from sprintz_jax.data.corpus import quantize, read_dat

MINI = pathlib.Path(__file__).parent / "data" / "mini_corpus"

CORPORA = ["ucr", "msrc12", "pamap", "ampds", "uci_gas"]
EXPECT_DIMS = {"ucr": 1, "msrc12": 80, "pamap": 14, "ampds": 3,
               "uci_gas": 18}


@pytest.mark.parametrize("name", CORPORA)
def test_parse_mini_corpus(name):
    mat = loaders.load_corpus(name, MINI)
    assert mat.ndim == 2 and mat.shape[0] > 50
    assert mat.shape[1] == EXPECT_DIMS[name]
    assert np.isfinite(mat).all()  # NaN handling (pamap) verified here


def test_ucr_interpolation_seams():
    # 5 interpolated points between instances: a 2-instance dataset of
    # lengths L each concatenates to 2L + 5 rows
    X, y = loaders.parse_ucr_dataset(MINI / "ucr" / "MiniRamp")
    series = loaders.load_ucr(MINI / "ucr" / "MiniRamp")
    assert series.shape == (X.shape[0] * X.shape[1]
                            + 5 * (X.shape[0] - 1), 1)
    assert len(y) == X.shape[0]


def test_msrc_drops_zero_rows():
    f = sorted((MINI / "msrc12").glob("*.csv"))[0]
    raw = np.loadtxt(f)
    parsed = loaders.parse_msrc12(f)
    assert parsed.shape[0] < raw.shape[0]  # the all-zero rows
    assert not (np.abs(parsed).sum(axis=1) == 0).any()


@pytest.mark.parametrize("name", CORPORA)
@pytest.mark.parametrize("elem_sz", [1, 2])
def test_mini_corpus_ratio_parity(name, elem_sz):
    """Quantized mini-corpus streams compress byte-identically to the
    reference build (when present) and round-trip losslessly."""
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    import oracle

    dt = np.uint8 if elem_sz == 1 else np.uint16
    mat = quantize(loaders.load_corpus(name, MINI), dtype=dt)
    ndims = mat.shape[1]
    flat = mat.reshape(-1)
    for codec in ("delta", "xff"):
        sc = api.SprintzCodec(codec, elem_sz)
        buf = sc.compress(mat)
        np.testing.assert_array_equal(sc.decompress(buf), flat)
        if oracle.available():
            ref = oracle.ref_compress(
                f"sprintz_compress_{codec}_{8 * elem_sz}b", flat, ndims)
            oracle.assert_stream_matches(buf, ref, f"{name}/{codec}")


def test_benchmark_layout_roundtrip(tmp_path):
    paths = loaders.corpus_to_benchmark("ampds", MINI, tmp_path)
    assert len(paths) == 4  # 2 dtypes x 2 orders
    mat = quantize(loaders.load_corpus("ampds", MINI), dtype=np.uint8)
    got = read_dat(tmp_path / "rowmajor" / "uint8" / "ampds.dat",
                   np.uint8, ndims=mat.shape[1])
    np.testing.assert_array_equal(got, mat)
