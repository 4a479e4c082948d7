"""chip_smoke.py's phases at tiny sizes on the CPU, and its contract.

On the card the same phases run at real sizes (``python chip_smoke.py``);
here they check the control flow and the byte-exact comparisons, plus the
rules around them: no ok line off the GPU, the last line's format, the
compile-cache directory, no silent switch to the golden codec, and the
per-backend FIRE scan unroll.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


@pytest.fixture
def rep():
    return cs.Report("cpu")


@pytest.mark.parametrize("codec,elem_sz,ndims", cs.GOLDEN_GRID)
def test_p1_golden(rep, codec, elem_sz, ndims):
    cs.p1_golden(rep, codec, elem_sz, ndims, 2048, seed=ndims)


def test_p1_vectors(rep):
    cs.p1_vectors(rep)


def test_p1_golden_detects_a_wrong_stream(rep, monkeypatch):
    """A stream that differs from the golden bytes fails the phase."""
    from sprintz_jax import api

    real = api.SprintzCodec.compress

    def corrupt(self, data, ndims=None):
        out = real(self, data, ndims)
        if self.backend == "golden":
            return out
        return out[:-1] + bytes([out[-1] ^ 1])

    monkeypatch.setattr(api.SprintzCodec, "compress", corrupt)
    with pytest.raises(AssertionError, match="differs from the golden"):
        cs.p1_golden(rep, "delta", 1, 3, 2048, seed=0)


def test_p2_archive_and_query(rep):
    cs.p2_archive(rep, 1 << 16, seed=0)
    cs.p2_query(rep, 1 << 16, seed=0)


def test_p2_fire(rep):
    cs.p2_fire(rep, 1 << 17, 1 << 15, seed=0)


def test_p2_corpus(rep):
    cs.p2_corpus(rep, 1 << 13, seed=0)


def test_p2_huf(rep):
    cs.p2_huf(rep, 1 << 16, seed=0)


def test_p2_huf_fails_on_a_wrong_device_decode(rep, monkeypatch):
    from sprintz_jax.entropy import huffman as hf

    real = hf._decode_jax

    def off_by_one(*args):
        out = real(*args).copy()
        out[0] ^= 1
        return out

    monkeypatch.setattr(hf, "_decode_jax", off_by_one)
    with pytest.raises(AssertionError, match="jax decode"):
        cs.p2_huf(rep, 1 << 16, seed=0)


def test_p2_batch(rep):
    cs.p2_batch(rep, 8, 1 << 12, seed=0)


def test_p3_multi_on_virtual_devices(rep):
    import jax

    assert len(jax.devices()) == 8  # conftest's virtual CPU mesh
    cs.p3_multi(rep, 8, 1 << 16, 1 << 16, seed=0)


def test_main_off_the_gpu_exits_nonzero_without_ok_line(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_ok_line_format():
    line = cs.ok_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                       "count": 1})
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_walk_is_seeded_and_sized():
    a = cs.walk(3, 4096, 64, np.uint16)
    b = cs.walk(3, 4096, 64, np.uint16)
    assert a.dtype == np.uint16 and a.shape == (32, 64)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, cs.walk(4, 4096, 64, np.uint16))
    flat = cs.walk(3, 1024 * 8, 8, np.uint8, runs=True)
    assert (np.diff(flat[:256], axis=0) == 0).all()  # a flat stretch
    assert (np.diff(flat[256:512], axis=0) != 0).any()
    assert cs.walk(0, 1000, 3, np.uint8, extra=2).size == 333 * 3 + 2


# ----------------------------------------------------------- compile cache

def test_compile_cache_follows_env(monkeypatch, tmp_path):
    from sprintz_jax.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    updates = []
    monkeypatch.setattr("jax.config.update",
                        lambda *a: updates.append(a))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert updates == []  # JAX reads the env var itself


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    from sprintz_jax.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    updates = []
    monkeypatch.setattr("jax.config.update",
                        lambda *a: updates.append(a))
    first = compile_cache.enable_compile_cache()
    assert first == compile_cache.enable_compile_cache()
    assert first == str(ROOT / ".cache" / "jax")
    assert updates == [("jax_compilation_cache_dir", first)] * 2


# ------------------------------------------------------ no hidden fallback

@pytest.mark.parametrize("module", ["encoder", "decoder"])
def test_auto_backend_raises_when_jax_path_cannot_import(monkeypatch,
                                                         module):
    import sprintz_jax
    from sprintz_jax.api import SprintzCodec

    x = (np.arange(4096) % 251).astype(np.uint8).reshape(-1, 8)
    buf = SprintzCodec("delta", 1).compress(x)
    monkeypatch.delattr(sprintz_jax, module)
    monkeypatch.setitem(sys.modules, f"sprintz_jax.{module}", None)
    with pytest.raises(ImportError):
        if module == "encoder":
            SprintzCodec("delta", 1).compress(x)
        else:
            SprintzCodec("delta", 1).decompress(buf)
    # the golden codec is still there, but only when asked for
    golden = SprintzCodec("delta", 1, backend="golden")
    assert golden.compress(x) == buf
    np.testing.assert_array_equal(golden.decompress(buf), x.reshape(-1))


def test_unknown_backend_rejected():
    from sprintz_jax.api import SprintzCodec

    with pytest.raises(ValueError, match="backend"):
        SprintzCodec("delta", 1, backend="numpy")


# --------------------------------------------------------- scan unroll

def test_scan_unroll_default_and_override(monkeypatch):
    from sprintz_jax import config

    monkeypatch.delenv("SPRINTZ_SCAN_UNROLL", raising=False)
    assert config.get("SPRINTZ_SCAN_UNROLL") == 8
    monkeypatch.setenv("SPRINTZ_SCAN_UNROLL", "16")
    assert config.get("SPRINTZ_SCAN_UNROLL") == 16


@pytest.mark.parametrize("unroll", [1, 4])
def test_fire_bytes_do_not_depend_on_scan_unroll(monkeypatch, unroll):
    """The unroll moves compile time and speed, never the output."""
    import jax.numpy as jnp

    from sprintz_jax.models import forecasters as fc

    rng = np.random.default_rng(unroll)
    rows = jnp.asarray(np.cumsum(rng.integers(-6, 7, (8 * 40, 3)), axis=0)
                       & 0xFF, jnp.int32)
    want = np.asarray(fc.fire_encode(rows, 8))
    monkeypatch.setattr(fc, "SCAN_UNROLL", unroll)
    errs = fc.fire_encode(rows, 8)
    np.testing.assert_array_equal(np.asarray(errs), want)
    np.testing.assert_array_equal(np.asarray(fc.fire_decode(errs, 8)),
                                  np.asarray(rows))


def test_native_library_reports_its_build():
    from sprintz_jax import native_host

    if native_host.get_lib() is None:
        pytest.skip("no g++ here")
    assert pathlib.Path(native_host.lib_path).exists()
    assert isinstance(native_host.march_native, bool)


# ------------------------------------------------------------ on the card

@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu):
    """The whole default run on the card, in a child process: this test
    process keeps JAX on the CPU, so the child is the card's one client."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
