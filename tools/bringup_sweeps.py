"""Device settings measured on the GPU when the codec was brought up.

    JAX_COMPILATION_CACHE_DIR=<empty dir> python tools/bringup_sweeps.py [--seed N]

Two sweeps, each printed one line per point beside the card's name and
power limit (the numbers behind PERF.md's bring-up findings):

- +Huf chunk size: coded bytes, native encode time, and decode time
  through the native host loop (backend "native") and through the device
  scan (backend "jax", host prep and transfers included) at cs=128 and
  cs=4096 on symbol streams of 4, 16 and 64 MiB. This decides the chunk
  size huff_compress picks and the route huff_decompress("auto") takes.
- FIRE scan unroll (models.forecasters.SCAN_UNROLL) at 8, 16 and 32:
  serial xff u8 16 MiB encode and decode at d1 and d3, decode at d64.
  For each: the first call on a cold persistent compile cache, the first
  call after jax.clear_caches() (a cache hit), and the warm time. Point
  JAX_COMPILATION_CACHE_DIR at an empty directory so the first is cold.

Host-clock times of single calls (warm = median of ``--reps`` calls);
the process uses one card.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import sys
import time

import jax
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from sprintz_jax.api import SprintzCodec  # noqa: E402
from sprintz_jax.entropy import huffman as hf  # noqa: E402
from sprintz_jax.models import forecasters  # noqa: E402
from sprintz_jax.utils.compile_cache import enable_compile_cache  # noqa: E402
from sprintz_jax.utils.gpu import card_line, device_info, require_gpu  # noqa: E402

MiB = 1 << 20


def timed(fn) -> tuple[object, float]:
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def warm_median(fn, reps: int) -> float:
    return statistics.median(timed(fn)[1] for _ in range(reps))


def huff_sweep(card: str, seed: int, reps: int,
               sizes=(4 * MiB, 16 * MiB, 64 * MiB)) -> None:
    x = chip_smoke.walk(seed, 2 * max(sizes), 64, np.uint8)
    sym_all = np.frombuffer(SprintzCodec("delta", 1).compress(x), np.uint8)
    for n in sizes:
        sym = sym_all[:n]
        for cs in (128, 4096):
            def enc():
                return hf.huff_compress(sym, chunk_symbols=cs,
                                        allow_stored=False)
            comp = enc()
            for backend in ("native", "jax"):
                chip_smoke.check_equal(hf.huff_decompress(comp, backend=backend),
                                       sym, f"huff {backend} cs={cs} {n}")
            te = warm_median(enc, reps)
            tn = warm_median(lambda: hf.huff_decompress(comp, backend="native"),
                             reps)
            tj = warm_median(lambda: hf.huff_decompress(comp, backend="jax"),
                             reps)
            print(f"+Huf cs={cs} {n} symbol B: coded {len(comp)} B, native "
                  f"encode {te:.4f} s, native decode {tn:.4f} s "
                  f"({n / tn / 1e9:.3f} GB/s), device scan decode {tj:.4f} s "
                  f"({n / tj / 1e9:.3f} GB/s) [{card}]", flush=True)


def _unroll_point(card: str, what: str, nbytes: int, unroll: int, fn,
                  reps: int):
    """Cold first call, warm median, cache-hit first call of ``fn``."""
    jax.clear_caches()
    out, cold = timed(fn)
    warm = warm_median(fn, reps)
    jax.clear_caches()
    _, hit = timed(fn)
    print(f"unroll {unroll}: {what} {nbytes} B cold-cache first {cold:.3f} s, "
          f"cache-hit first {hit:.3f} s, warm {warm:.4f} s, compile~ "
          f"{cold - warm:.3f} s cold / {hit - warm:.3f} s hit, "
          f"{nbytes / warm / 1e9:.3f} GB/s warm [{card}]", flush=True)
    return out


def unroll_sweep(card: str, seed: int, reps: int, nbytes: int = 16 * MiB,
                 unrolls=(8, 16, 32)) -> None:
    codec = SprintzCodec("xff", 1)
    default = forecasters.SCAN_UNROLL
    for ndims, ops in ((1, ("encode", "decode")), (3, ("encode", "decode")),
                       (64, ("decode",))):
        x = chip_smoke.walk(seed, nbytes, ndims, np.uint8)
        forecasters.SCAN_UNROLL = default
        want = codec.compress(x)
        for unroll in unrolls:
            forecasters.SCAN_UNROLL = unroll
            what = f"serial xff d{ndims} u8"
            if "encode" in ops:
                buf = _unroll_point(card, f"{what} encode", x.nbytes, unroll,
                                    lambda: codec.compress(x), reps)
                if buf != want:
                    raise AssertionError(f"unroll {unroll}: {what} encode "
                                         "bytes differ")
            out = _unroll_point(card, f"{what} decode", x.nbytes, unroll,
                                lambda: codec.decompress(want), reps)
            chip_smoke.check_equal(out, x, f"unroll {unroll} {what}")
    forecasters.SCAN_UNROLL = default
    jax.clear_caches()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    cache = enable_compile_cache()
    info = device_info()
    require_gpu(info)
    card = card_line().splitlines()[0]
    print(f"device {info}, compile cache {cache!r} [{card}]", flush=True)
    huff_sweep(card, args.seed, args.reps)
    unroll_sweep(card, args.seed, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
