"""DataFrame pipeline: quantization, codec chains, squeeze drivers."""

import numpy as np
import pandas as pd
import pytest

from sprintz_jax.frames import (
    ByteShuffle,
    CodecSearch,
    Delta,
    DoubleDelta,
    DynamicDelta,
    Lzma,
    Quantize,
    Sprintz,
    Zigzag,
    Zlib,
    dequantize,
    encode,
    decode,
    encode_measure_decode,
    infer_qparams,
    quantize,
)


def make_df(rng):
    n = 2000
    return pd.DataFrame({
        "walk16": (np.cumsum(rng.integers(-3, 4, n)) & 0xFFFF).astype(np.uint16),
        "small8": rng.integers(0, 5, n).astype(np.uint8),
        "wide32": np.cumsum(rng.integers(-100, 101, n)).astype(np.int32),
        "price": np.round(rng.normal(100, 5, n), 2),
        "flags": rng.integers(0, 2, n).astype(np.uint8),
    })


def test_lossless_base10_quantization(rng):
    x = np.round(rng.normal(50, 10, 5000), 3)
    p = infer_qparams(x)
    assert p is not None and p.scale == 1000.0
    np.testing.assert_array_equal(dequantize(quantize(x, p), p), x)


def test_quantization_with_nans(rng):
    x = np.round(rng.normal(0, 1, 1000), 2)
    x[::17] = np.nan
    p = infer_qparams(x)
    assert not p.allfinite
    back = dequantize(quantize(x, p), p)
    np.testing.assert_array_equal(back, x)  # NaN == NaN via array_equal? no
    assert np.array_equal(back, x, equal_nan=True)


@pytest.mark.parametrize("chain", [
    [Delta(), Zigzag()],
    [DoubleDelta(), Zigzag()],
    [DynamicDelta()],
    [ByteShuffle()],
    [Quantize(), Delta()],
    [CodecSearch()],
    [Quantize(), Zlib()],
    [Lzma()],
])
def test_chain_roundtrip(rng, chain):
    df = make_df(rng)
    res = encode_measure_decode({"d": df}, chain)
    assert res.lossless, type(chain[0]).__name__


def test_sprintz_column_codec(rng):
    df = make_df(rng)[["walk16", "small8"]]
    res = encode_measure_decode({"d": df}, [Sprintz("delta")])
    assert res.lossless
    assert res.ratio > 1.5  # both columns are highly compressible


def test_full_pipeline_compresses(rng):
    df = make_df(rng)
    res = encode_measure_decode(
        {"d": df}, [Quantize(), DynamicDelta(), Zigzag(), Zlib()])
    assert res.lossless
    assert res.ratio > 1.5


def test_multi_frame_headers(rng):
    dfs = {"a": make_df(rng), "b": make_df(rng)}
    enc, headers = encode(dfs, [Delta(), Zigzag()])
    dec = decode(enc, headers, [Delta(), Zigzag()])
    for name in dfs:
        for c in dfs[name].columns:
            np.testing.assert_array_equal(
                dec[name][c], dfs[name][c].to_numpy())


def test_storage_backends(tmp_path, rng):
    from sprintz_jax.frames.storage import available_backends, load_df, save_df

    df = make_df(rng)
    for name in available_backends():
        p = save_df(df, tmp_path / f"t_{name}", fmt=name)
        back = load_df(p)
        for c in df.columns:
            np.testing.assert_array_equal(back[c].to_numpy(),
                                          df[c].to_numpy(), err_msg=name)
    p = save_df(df, tmp_path / "smart", fmt="smart")
    back = load_df(p)
    assert set(back.columns) == set(df.columns)


def test_colsum_predictor_roundtrip():
    import pandas as pd

    from sprintz_jax.frames.codecs import ColSumPredictor, Delta
    from sprintz_jax.frames.dfsqueeze import encode, decode

    rng = np.random.default_rng(0)
    a = rng.integers(0, 100, 500).astype(np.int64)
    b = rng.integers(0, 100, 500).astype(np.int64)
    total = a + b + rng.integers(-2, 3, 500)  # near-sum column
    df = pd.DataFrame({"a": a, "b": b, "total": total})
    chain = [ColSumPredictor(["a", "b"], "total"), Delta()]
    enc, headers = encode({"x": df}, chain)
    # residual column must be tiny vs the raw column
    assert np.abs(enc["x"]["total"]).max() <= 4 * 500
    dec = decode(enc, headers, chain)
    for c in df.columns:
        np.testing.assert_array_equal(dec["x"][c], df[c].to_numpy())


def test_colsum_predictor_weights():
    import pandas as pd

    from sprintz_jax.frames.codecs import ColSumPredictor
    from sprintz_jax.frames.dfsqueeze import encode, decode

    rng = np.random.default_rng(1)
    a = rng.integers(0, 50, 300).astype(np.int32)
    tgt = (3 * a + rng.integers(0, 2, 300)).astype(np.int32)
    df = pd.DataFrame({"a": a, "t": tgt})
    chain = [ColSumPredictor(["a"], "t", weights=[3.0])]
    enc, headers = encode({"x": df}, chain)
    assert np.abs(enc["x"]["t"]).max() <= 1
    dec = decode(enc, headers, chain)
    np.testing.assert_array_equal(dec["x"]["t"], tgt)
