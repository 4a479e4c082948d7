"""sprintz-jax tour: the main APIs in one script.

Run: python examples/demo.py   (on the process's default device; set
JAX_PLATFORMS=cpu to stay on the host)
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import sprintz_jax
from sprintz_jax import univariate
from sprintz_jax.checkpoint import compress_with_sidecar, decode_range
from sprintz_jax.data import synthetic_corpus
from sprintz_jax.query import Operation, QueryParams, query
from sprintz_jax.validate import validate_stream


def main():
    # --- basic compress/decompress on multivariate sensor-like data
    data = synthetic_corpus("pamap_like", nrows=20_000)  # (rows, 31) uint8
    buf = sprintz_jax.compress(data, codec="xff")
    out = sprintz_jax.decompress(buf, codec="xff", elem_sz=1)
    assert np.array_equal(out, data.reshape(-1))
    print(f"FIRE codec: {data.nbytes} -> {len(buf)} bytes "
          f"({data.nbytes / len(buf):.2f}x)")

    # --- the "+Huf" variant
    huf = sprintz_jax.SprintzCodec("xff", 1, entropy="huffman")
    buf_huf = huf.compress(data)
    print(f"FIRE+Huf:   {data.nbytes} -> {len(buf_huf)} bytes "
          f"({data.nbytes / len(buf_huf):.2f}x)")

    # --- validate before trusting a stream
    rep = validate_stream(buf)
    print(f"validate: ok={rep.ok} groups={rep.ngroups} "
          f"data_blocks={rep.data_blocks} run_blocks={rep.run_blocks}")

    # --- queries over compressed data, no materialization
    plain = sprintz_jax.SprintzCodec("delta", 1)
    b2 = plain.compress(data)
    r = query(b2, QueryParams(Operation.REDUCE_MAX, materialize=False),
              "delta", 1)
    print(f"pushdown max of column 0 (no decode round trip): {r.max[0]}")

    # --- seekable streams: decode a slice without replaying the prefix
    stream, sidecar = compress_with_sidecar(
        data.reshape(-1), data.shape[1], codec="delta", every_groups=64)
    rows = decode_range(stream, sidecar, 15_000, 100)
    assert np.array_equal(rows, data[15_000:15_100])
    print(f"seek decode @15000 ok (sidecar {len(sidecar.to_bytes())} bytes)")

    # --- chunk-parallel decode: every sidecar chunk decodes concurrently
    from sprintz_jax.checkpoint import decompress_parallel

    flat = decompress_parallel(stream, sidecar)
    assert np.array_equal(flat, data.reshape(-1))
    print(f"chunk-parallel decode ok "
          f"({len(sidecar.byte_offsets)} chunks in one device pass)")

    # --- univariate methods
    y = (np.cumsum(np.random.default_rng(0).integers(-3, 4, 8000))
         & 0xFFFF).astype(np.uint16)
    for m in ("sprintz", "dyndelta", "sprintzpack"):
        b = univariate.compress_univariate(y, m)
        assert np.array_equal(
            univariate.decompress_univariate(b, m, elem_sz=2), y)
        print(f"univariate {m:12s}: {y.nbytes / len(b):.2f}x")


if __name__ == "__main__":
    main()
