"""Corpus benchmark: compression ratios + throughput across the evaluation
corpus profiles, for both codecs and elem sizes, with optional byte-level
comparison against a locally compiled reference build.

Usage:  python bench_corpus.py [--nrows N] [--quick]
Prints a table to stdout; no driver JSON (see bench.py for that).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nrows", type=int, default=50_000)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--platform", default="cpu", choices=["cpu", "device"],
                    help="ratio tables default to CPU; 'device' runs on "
                         "the process's default device (the GPU)")
    ap.add_argument("--mini", action="store_true",
                    help="use the checked-in real-format miniature corpus "
                         "(tests/data/mini_corpus) instead of synthetic "
                         "profiles")
    ap.add_argument("--data-dir", default=None,
                    help="parse REAL corpora from this directory "
                         "(ucr/ msrc12/ pamap/ ampds/ uci_gas/ subdirs)")
    args = ap.parse_args()

    from sprintz_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    from sprintz_jax import api
    from sprintz_jax.data import CORPUS_PROFILES, load_dataset

    sys.path.insert(0, "tests")
    try:
        import oracle
        have_oracle = oracle.available()
    except ImportError:
        have_oracle = False

    real_dir = args.data_dir
    if args.mini:
        real_dir = "tests/data/mini_corpus"
    if real_dir:
        import pathlib

        from sprintz_jax.data import loaders
        from sprintz_jax.data.corpus import quantize

        names = [n for n in loaders.CORPUS_LOADERS
                 if (pathlib.Path(real_dir) / n).exists()]

        def load(name, dtype, nrows):
            mat = quantize(loaders.load_corpus(name, real_dir), dtype=dtype)
            return mat[:nrows]
    else:
        names = list(CORPUS_PROFILES)
        if args.quick:
            names = names[:2]

        def load(name, dtype, nrows):
            return load_dataset(name, dtype=dtype, nrows=nrows)

    print(f"{'corpus':14s} {'dtype':7s} {'codec':6s} {'ratio':>7s} "
          f"{'+huf':>7s} {'enc MB/s':>9s} {'dec MB/s':>9s} {'ref?':>5s}")
    for name in names:
        for dtype in (np.uint8, np.uint16):
            data = load(name, dtype, args.nrows)
            ndims = data.shape[1]
            flat = data.reshape(-1)
            for codec in ("delta", "xff"):
                sc = api.SprintzCodec(codec, flat.dtype.itemsize)
                t0 = time.perf_counter()
                buf = sc.compress(data)
                t_enc = time.perf_counter() - t0
                t0 = time.perf_counter()
                out = sc.decompress(buf)
                t_dec = time.perf_counter() - t0
                assert np.array_equal(out, flat), f"roundtrip {name} {codec}"
                ratio = flat.nbytes / len(buf)
                huf = api.SprintzCodec(codec, flat.dtype.itemsize,
                                       entropy="huffman")
                ratio_huf = flat.nbytes / len(huf.compress(data))

                ref_note = "-"
                if have_oracle:
                    refname = (f"sprintz_compress_{codec}_"
                               f"{8 * flat.dtype.itemsize}b")
                    rbuf, rmin = oracle.ref_compress(refname, flat, ndims)
                    ref_note = "==" if (
                        rmin <= len(buf) <= len(rbuf)
                        and buf == rbuf[: len(buf)]) else "DIFF"

                print(f"{name:14s} {np.dtype(dtype).name:7s} {codec:6s} "
                      f"{ratio:7.2f} {ratio_huf:7.2f} "
                      f"{flat.nbytes / t_enc / 1e6:9.1f} "
                      f"{flat.nbytes / t_dec / 1e6:9.1f} {ref_note:>5s}")


if __name__ == "__main__":
    main()
