"""Persistent JAX compilation cache for the entry points.

The CLI, ``bench.py``, ``bench_corpus.py`` and ``chip_smoke.py`` call
``enable_compile_cache()`` once at start-up; importing the library sets
nothing. The cache directory is part of every entry's key, so it is a
fixed path, never one that moves from run to run.
"""

from __future__ import annotations

import os
import pathlib

# <checkout>/.cache/jax (.cache/ is git-ignored)
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".cache" / "jax"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    this function sets no other directory; otherwise the cache goes to
    ``DEFAULT_DIR``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
