"""Test configuration.

Tests run JAX on CPU with 8 virtual devices so that multi-device sharding
(mesh/shard_map) paths are exercised without a GPU. Tests that need the
card carry the ``gpu`` marker and skip here (see the ``gpu`` fixture).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# tests always run on the virtual 8-device CPU mesh, even where a GPU
# plugin is installed
jax.config.update("jax_platforms", "cpu")

import subprocess  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless nvidia-smi lists a GPU. Decided when a ``gpu``-marked
    test runs, never at import, so every xdist worker collects the same
    tests. JAX in the test process stays on the CPU; a card test runs
    its work in a child process."""
    try:
        res = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        pytest.skip("no nvidia-smi: no GPU on this machine")
    if res.returncode != 0 or "GPU" not in res.stdout:
        pytest.skip("nvidia-smi lists no GPU")


@pytest.fixture
def rng():
    return np.random.default_rng(123)


def make_stream(rng, n, elem_sz, kind):
    """Input families mirroring the reference test harness
    (test/compress_testing.hpp:252-425): random, small-range, zeros,
    sparse (mostly zero), and modular ramps."""
    dt = np.uint8 if elem_sz == 1 else np.uint16
    hi = 256 if elem_sz == 1 else 65536
    if kind == "rand":
        return rng.integers(0, hi, n).astype(dt)
    if kind == "small":
        return rng.integers(0, 8, n).astype(dt)
    if kind == "zeros":
        return np.zeros(n, dtype=dt)
    if kind == "sparse":
        return np.where(rng.random(n) < 0.05,
                        rng.integers(0, 100, n), 0).astype(dt)
    if kind == "ramp":
        return (np.arange(n) % 250).astype(dt)
    raise ValueError(kind)


KINDS = ["rand", "small", "zeros", "sparse", "ramp"]
