"""CLI round-trips (sprintz_jax.__main__): container + raw modes."""

import ast

import numpy as np
import pytest

from sprintz_jax.__main__ import main, MAGIC, MAGIC_V1, _pack_flags
from sprintz_jax import api


@pytest.fixture
def raw_file(tmp_path, rng):
    data = (np.cumsum(rng.integers(-5, 6, (3000, 8)), axis=0) % 256
            ).astype(np.uint8)
    p = tmp_path / "raw.bin"
    data.tofile(p)
    return p, data


@pytest.mark.parametrize("codec", ["delta", "xff"])
@pytest.mark.parametrize("entropy", ["none", "huffman"])
def test_cli_roundtrip_container(tmp_path, raw_file, codec, entropy):
    raw, data = raw_file
    spz = tmp_path / "out.spz"
    out = tmp_path / "rt.bin"
    assert main(["compress", str(raw), str(spz), "--ndims", "8",
                 "--codec", codec, "--entropy", entropy]) == 0
    assert spz.read_bytes()[:5] == MAGIC
    # xff >= 64 KiB gets a sidecar by default (chunk-parallel decode)
    assert bool(spz.read_bytes()[5] & 0x20) == (codec == "xff")
    # container decode needs NO flags: codec/dtype/entropy ride the header
    assert main(["decompress", str(spz), str(out)]) == 0
    assert np.array_equal(np.fromfile(out, np.uint8),
                          data.reshape(-1))
    assert main(["info", str(spz)]) == 0


def test_cli_reads_v1_containers(tmp_path, raw_file):
    raw, data = raw_file
    spz = tmp_path / "v1.spz"
    # v1 layout: 1-bit codec / elem_sz / entropy fields
    stream = api.compress(data, codec="xff", ndims=8)
    spz.write_bytes(MAGIC_V1 + bytes([1]) + stream)
    out = tmp_path / "rt.bin"
    assert main(["decompress", str(spz), str(out)]) == 0
    assert np.array_equal(np.fromfile(out, np.uint8), data.reshape(-1))


def test_cli_sidecar_modes(tmp_path, raw_file):
    raw, data = raw_file
    for flags, expect_sc in ([], True), (["--sidecar", "never"], False), \
            (["--sidecar", "always"], True):
        spz = tmp_path / "s.spz"
        out = tmp_path / "rt.bin"
        assert main(["compress", str(raw), str(spz), "--ndims", "8",
                     "--codec", "xff"] + flags) == 0
        assert bool(spz.read_bytes()[5] & 0x20) == expect_sc
        assert main(["decompress", str(spz), str(out)]) == 0
        assert np.array_equal(np.fromfile(out, np.uint8), data.reshape(-1))


def test_pack_flags_rejects_overflow():
    with pytest.raises(AssertionError):
        _pack_flags("delta", 4, "none")


def test_cli_raw_stream_is_reference_exact(tmp_path, raw_file):
    raw, data = raw_file
    spz = tmp_path / "out.raw.spz"
    assert main(["compress", str(raw), str(spz), "--ndims", "8",
                 "--raw"]) == 0
    assert spz.read_bytes() == api.compress(data, ndims=8)
    out = tmp_path / "rt.bin"
    assert main(["decompress", str(spz), str(out), "--raw"]) == 0
    assert np.array_equal(np.fromfile(out, np.uint8), data.reshape(-1))


def test_cli_query_matches_numpy(tmp_path, raw_file, capsys):
    raw, data = raw_file
    spz = tmp_path / "out.spz"
    main(["compress", str(raw), str(spz), "--ndims", "8"])
    assert main(["query", str(spz), "--op", "sum"]) == 0
    got = ast.literal_eval(capsys.readouterr().out.strip())
    assert got == data.sum(axis=0, dtype=np.int64).tolist()


def test_cli_u16(tmp_path, rng, capsys):
    data = (np.cumsum(rng.integers(-300, 301, (2000, 4)), axis=0)
            % (1 << 16)).astype(np.uint16)
    raw = tmp_path / "raw16.bin"
    data.tofile(raw)
    spz = tmp_path / "o.spz"
    out = tmp_path / "rt.bin"
    assert main(["compress", str(raw), str(spz), "--ndims", "4",
                 "--dtype", "u16", "--codec", "xff"]) == 0
    assert main(["decompress", str(spz), str(out)]) == 0
    assert np.array_equal(np.fromfile(out, np.uint16), data.reshape(-1))
    # info + query on the 2-byte container (ADVICE r2)
    assert main(["info", str(spz)]) == 0
    assert "uint16" in capsys.readouterr().out
    assert main(["query", str(spz), "--op", "max"]) == 0
    got = ast.literal_eval(capsys.readouterr().out.strip())
    assert got == data.max(axis=0).tolist()


def test_cli_rejects_misaligned_ndims(tmp_path, raw_file):
    raw, _ = raw_file
    assert main(["compress", str(raw), str(tmp_path / "x"),
                 "--ndims", "7"]) == 2
