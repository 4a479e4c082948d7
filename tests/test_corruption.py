"""Corruption fuzz: truncated / bit-flipped streams must never crash.

The format carries no checksums (format.h:47-62 — the reference decoder
trusts metadata blindly), so corrupt input cannot always be *detected*;
the contract here is strictly: ``api.decompress`` either returns an array
or raises ``CorruptStreamError`` — never IndexError / segfault / other
exceptions — for both the native and the Python header walkers.
"""

import numpy as np
import pytest

from sprintz_jax import api
from sprintz_jax.errors import CorruptStreamError

from conftest import make_stream


def _attempt(buf, codec, elem_sz):
    try:
        out = api.decompress(bytes(buf), codec=codec, elem_sz=elem_sz)
        assert isinstance(out, np.ndarray)
    except CorruptStreamError:
        pass


@pytest.mark.parametrize("codec,elem_sz", [("delta", 1), ("xff", 2)])
def test_truncation_fuzz(rng, codec, elem_sz):
    x = make_stream(rng, 3000, elem_sz, "sparse")
    buf = api.compress(x.reshape(-1, 5), codec=codec)
    cuts = sorted(set(
        list(range(0, 24)) + list(rng.integers(0, len(buf), 40))))
    for cut in cuts:
        _attempt(buf[:cut], codec, elem_sz)


@pytest.mark.parametrize("codec,elem_sz", [("delta", 2), ("xff", 1)])
def test_bitflip_fuzz(rng, codec, elem_sz):
    x = make_stream(rng, 3000, elem_sz, "sparse")
    buf = bytearray(api.compress(x.reshape(-1, 5), codec=codec))
    for _ in range(120):
        pos = int(rng.integers(0, len(buf)))
        bit = int(rng.integers(0, 8))
        orig = buf[pos]
        buf[pos] ^= 1 << bit
        _attempt(buf, codec, elem_sz)
        buf[pos] = orig


def test_python_walker_matches_native_on_corrupt(rng, monkeypatch):
    """Both walkers enforce identical bounds: same accept/reject verdict."""
    from sprintz_jax import decoder, native_host
    from sprintz_jax.golden.stream import read_metadata_rle

    if native_host.get_lib() is None:
        pytest.skip("native host lib unavailable")
    x = make_stream(rng, 4000, 1, "sparse")
    buf = api.compress(x.reshape(-1, 5), codec="delta")
    ngroups, _, ndims = read_metadata_rle(buf)
    for cut in rng.integers(8, len(buf), 30):
        cut_buf = buf[: int(cut)]

        def run(walker):
            try:
                idx = walker(cut_buf)
                return ("ok", idx.total_rows, idx.tail_offset)
            except CorruptStreamError:
                return ("corrupt",)

        native = run(lambda b: decoder.walk_headers(b, ngroups, ndims, 1))
        py = run(lambda b: decoder._walk_headers_py(b, ngroups, ndims, 1))
        assert native == py, f"cut={cut}"
