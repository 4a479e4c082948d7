"""Real multi-process multi-host simulation (SURVEY §4's missing layer).

The reference has no distributed tests at all; this framework's
multi-host scaling story is jax.distributed over several hosts, which
this test simulates
faithfully: TWO separate OS processes, each with 4 virtual CPU devices,
joined through a Gloo coordinator into one 8-device global mesh. Each
worker holds only its host-local input slice; both must produce the
byte-exact single-chip stream (mp_compress) and the exact decoded values
(mp_decompress) — see tests/mp_worker.py for the checked cases
(delta/xff × u8/u16, RLE runs crossing the process boundary).

Also covers the in-process pieces of parallel/multihost.py.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

_WORKER = os.path.join(os.path.dirname(__file__), "mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_byte_exact(tmp_path):
    """2 processes x 4 devices: distributed encode/decode is byte-exact."""
    # pre-build the native host lib so the workers don't both compile it
    from sprintz_jax import native_host

    native_host.get_lib()

    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)  # worker pins cpu in-process
    outs = [str(tmp_path / f"worker{i}.out") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(port), str(i), "2", outs[i]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i]}"
        with open(outs[i]) as f:
            line = f.read()
        assert line.startswith("OK "), f"worker {i}: {line}\n{logs[i]}"


def test_host_local_elems_partition():
    """Single-process: the slice covers everything exactly once."""
    from sprintz_jax.parallel import multihost as mh

    for ndims, n in [(7, 7 * 8 * 53 + 11), (6, 6 * 8 * 16), (3, 50)]:
        sl = mh.host_local_elems(n, ndims)
        assert sl.start == 0 and sl.stop == n


def test_mp_compress_single_process_matches_encoder(rng):
    """mp_compress degrades to the single-chip byte stream in-process."""
    from sprintz_jax import encoder
    from sprintz_jax.parallel import multihost as mh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = mh.global_mesh()
    for codec, dt, ndims in [("delta", np.uint8, 9), ("xff", np.uint8, 5)]:
        n = ndims * 8 * 41 + 3
        flat = rng.integers(0, 60, size=n, dtype=dt)
        flat[n // 4: n // 4 + 500] = 9
        got = mh.mp_compress(flat, n, ndims, codec=codec, mesh=mesh)
        assert got == encoder.compress(flat, ndims, codec=codec)
        dec = mh.mp_decompress(got, codec=codec, elem_sz=dt().itemsize,
                               mesh=mesh)
        np.testing.assert_array_equal(dec, flat)
