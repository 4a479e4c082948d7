"""Entropy size parity study: our Huffman stage vs the REAL Huff0.

SURVEY §2.9 rules Huff0 *bit*-compatibility out of scope but size
parity IN scope (the paper pipes sprintz output through Huff0,
/root/reference/communicate/method.tex:300-303; its in-repo
entropy.cpp:22-44 is an empty-table stub). This study compares, on the
sprintz residual streams of every mini-corpus cell:

- ours @ cs=128 (for a chunk-parallel device decode) and cs=4096
  (the default),
  production containers (stored-escape enabled),
- zstd's actual Huff0 (``HUF_compress1X_repeat``, fresh table per
  64 KiB block, linked from the system libzstd.a via
  native/huf0_size.c) — per-block sizes summed with stored blocks
  counted at raw size (no framing charged to Huff0: conservative
  against us),
- the order-0 Shannon bound per 64 KiB block (no table cost: the
  absolute floor for any order-0 coder).

Also decomposes OUR container overhead per cell: 12-byte header +
128-byte code table + per-chunk size entries + per-chunk byte-align
padding, so the device-chunking ratio tax is quantified
(VERDICT r4 item 4). Writes the table into docs/RATIOS.md by hand —
this script just prints it.

Run: python tools/entropy_parity.py  (CPU; ~1 min)
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, ".")

BS = 65536  # Huff0 block size (HUF_BLOCKSIZE_MAX is 128 KiB; zstd
# feeds Huff0 its literals in <=128 KiB chunks; 64 KiB is the
# classic FSE/huf CLI operating point)


def build_huf0() -> str | None:
    """Compile the Huff0 size oracle against the system libzstd.a."""
    src = os.path.join(os.path.dirname(__file__), "..", "native",
                       "huf0_size.c")
    out = "/tmp/refbuild/huf0_size"
    os.makedirs("/tmp/refbuild", exist_ok=True)
    if os.path.exists(out) and (os.path.getmtime(out)
                                >= os.path.getmtime(src)):
        return out
    for lib in ("/usr/lib/x86_64-linux-gnu/libzstd.a", "-lzstd"):
        r = subprocess.run(["gcc", "-O2", "-o", out, src, lib],
                           capture_output=True)
        if r.returncode == 0:
            return out
    print("huf0 oracle build failed:", r.stderr.decode()[:400],
          file=sys.stderr)
    return None


def huf0_size(tool: str, payload: bytes, bs: int = BS) -> int:
    """Total real-Huff0 compressed size, stored blocks at raw size."""
    r = subprocess.run([tool, str(bs)], input=payload,
                       capture_output=True, check=True)
    total = 0
    for line in r.stdout.split():
        pass
    for line in r.stdout.decode().splitlines():
        n, h = map(int, line.split())
        total += h if h > 0 else n
    return total


def order0_bound(payload: bytes, bs: int = BS) -> float:
    """Sum over 64 KiB blocks of n*H0/8 — the no-table order-0 floor."""
    arr = np.frombuffer(payload, np.uint8)
    total = 0.0
    for lo in range(0, len(arr), bs):
        blk = arr[lo:lo + bs]
        c = np.bincount(blk, minlength=256).astype(np.float64)
        p = c[c > 0] / blk.size
        total += blk.size * float(-(p * np.log2(p)).sum()) / 8
    return total


def our_overhead(comp: bytes) -> dict:
    """Decompose our container: header+table, size entries, align pad."""
    from sprintz_jax.entropy import huffman as hf

    n, cs, nchunks, t, sizes, offsets = hf._parse(comp)
    payload_bytes = int(sizes.sum())
    struct = len(comp) - payload_bytes  # header + table + size entries
    # byte-align pad: each chunk rounds its bit length up to bytes
    return {"struct": struct, "payload": payload_bytes,
            "nchunks": nchunks}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from sprintz_jax import api
    from sprintz_jax.data import loaders
    from sprintz_jax.data.corpus import quantize
    from sprintz_jax.entropy import huffman as hf

    tool = build_huf0()
    real_dir = "tests/data/mini_corpus"
    names = [n for n in loaders.CORPUS_LOADERS
             if os.path.exists(os.path.join(real_dir, n))]
    print(f"{'corpus':10s} {'dt':3s} {'codec':5s} {'stream':>8s} "
          f"{'ours128':>8s} {'ours4096':>8s} {'huf0-64k':>8s} "
          f"{'bound':>8s} {'gap4096':>7s} {'tax128':>7s}")
    rows = []
    for name in names:
        for dtype in (np.uint8, np.uint16):
            data = quantize(loaders.load_corpus(name, real_dir),
                            dtype=dtype)
            for codec in ("delta", "xff"):
                sc = api.SprintzCodec(codec, dtype().itemsize)
                stream = sc.compress(data)
                payload = np.frombuffer(stream, np.uint8)
                ours = {}
                for cs in (128, 4096):
                    comp = hf.huff_compress(payload, chunk_symbols=cs)
                    ours[cs] = len(comp)
                h0 = huf0_size(tool, bytes(stream)) if tool else 0
                bd = order0_bound(bytes(stream))
                gap = (ours[4096] - h0) / h0 * 100 if h0 else float("nan")
                tax = (ours[128] - ours[4096]) / ours[4096] * 100
                print(f"{name:10s} u{8*dtype().itemsize:<2d} {codec:5s} "
                      f"{len(stream):8d} {ours[128]:8d} {ours[4096]:8d} "
                      f"{h0:8d} {bd:8.0f} {gap:6.1f}% {tax:6.1f}%")
                rows.append((name, dtype().itemsize, codec, len(stream),
                             ours[128], ours[4096], h0, bd))
    # aggregate
    tot = np.array([[r[3], r[4], r[5], r[6], r[7]] for r in rows]).sum(0)
    print(f"{'TOTAL':10s} {'':3s} {'':5s} {tot[0]:8.0f} {tot[1]:8.0f} "
          f"{tot[2]:8.0f} {tot[3]:8.0f} {tot[4]:8.0f} "
          f"{(tot[2]-tot[3])/tot[3]*100:6.1f}% "
          f"{(tot[1]-tot[2])/tot[2]*100:6.1f}%")


if __name__ == "__main__":
    main()
