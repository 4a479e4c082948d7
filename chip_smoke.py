"""Run the codec's main path on the GPU once and check every byte.

    python chip_smoke.py            # one card: P0 device, P1 exactness,
                                    # P2 real sizes through the public API
    python chip_smoke.py --multi    # four cards: P0 and P3 (sharded
                                    # encode/decode) only

Every phase runs in this one process, so each card has one JAX client.
Data comes from generators seeded by ``--seed``. A phase that fails stops
the script with a non-zero exit; the last line of stdout is
``{"ok": true, "device": {...}}`` only when every phase passed. Times and
peak memory are printed for information, beside the card's name and power
limit; they claim nothing.

Phases:
  P0  the device: JAX's platform must be ``gpu``; the native host library
      must have loaded.
  P1  exactness against the plain references at small sizes: the 8 stream
      vectors produced by the reference C++ build (tests/vectors), and the
      scalar golden codec for delta/xff x u8/u16 x ndims 1/3/18/64. Bytes
      are compared; the tolerance is zero.
  P2  real sizes through SprintzCodec / compress / decompress /
      compress_seekable / query / compress_batch: each item round-trips
      exactly.
  P3  (``--multi``) dp_compress / dp_decompress over a 4-card mesh,
      byte-identical to the single-device encoder.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import pathlib
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import sprintz_jax
from sprintz_jax import encoder, native_host
from sprintz_jax.api import SprintzCodec
from sprintz_jax.data import CORPUS_PROFILES, synthetic_corpus
from sprintz_jax.entropy import huffman as hf
from sprintz_jax.query import Operation, QueryParams, query
from sprintz_jax.utils.compile_cache import enable_compile_cache
from sprintz_jax.utils.gpu import card_line, device_info, require_gpu

VECTORS = pathlib.Path(__file__).resolve().parent / "tests" / "vectors"
MiB = 1 << 20

# real sizes of the default run (P2) and of --multi (P3)
SIZES = dict(archive_u16=1024 * MiB, query_u8=256 * MiB, fire_par=256 * MiB,
             fire_serial=16 * MiB, corpus=16 * MiB, huf=64 * MiB,
             batch_streams=512, batch_bytes=64 << 10, golden_elems=1 << 15)
MULTI_SIZES = dict(archive_u16=1024 * MiB, fire_par=256 * MiB)


class Report:
    """Prints one line per checked item, with its times and the peak
    device memory so far, labelled with the card."""

    def __init__(self, card: str):
        self.card = card

    def item(self, phase: str, label: str, **fields) -> None:
        stats = jax.devices()[0].memory_stats() or {}
        fields["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
        text = ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in fields.items())
        print(f"{phase} {label}: ok, {text} [{self.card}]", flush=True)


def twice(fn):
    """Call ``fn`` twice; return (second result, first s, second s).

    The first call includes compilation, the second is warm."""
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    out = fn()
    return out, t1 - t0, time.perf_counter() - t1


@functools.partial(jax.jit, static_argnames=("rows", "ndims", "dtype",
                                             "runs"))
def _walk_device(key, rows, ndims, dtype, runs):
    steps = jax.random.randint(key, (rows, ndims), -6, 7, jnp.int32)
    if runs:
        # every third 256-row segment is flat: zero-width blocks -> RLE
        flat = (jnp.arange(rows) // 256) % 3 == 0
        steps = jnp.where(flat[:, None], 0, steps)
    bits = 8 * jnp.dtype(dtype).itemsize
    return (jnp.cumsum(steps, axis=0) & ((1 << bits) - 1)).astype(dtype)


def walk(seed: int, nbytes: int, ndims: int, dtype, runs: bool = False,
         extra: int = 0) -> np.ndarray:
    """A (rows, ndims) random walk of about ``nbytes`` bytes, made on the
    device from ``seed``; ``extra`` appends that many flat elements (a
    ragged tail the verbatim path must carry)."""
    dtype = np.dtype(dtype)
    rows = max(nbytes // (ndims * dtype.itemsize), 1)
    x = np.asarray(_walk_device(jax.random.key(seed), rows, ndims,
                                jnp.dtype(dtype), runs))
    if extra:
        return np.concatenate([x.reshape(-1), x.reshape(-1)[:extra]])
    return x


def check_equal(got: np.ndarray, want: np.ndarray, what: str) -> None:
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    if got.dtype != want.dtype or got.shape != want.shape or not \
            np.array_equal(got, want):
        bad = (np.flatnonzero(got != want)[:5]
               if got.shape == want.shape else "shape")
        raise AssertionError(f"{what}: mismatch ({got.dtype}{got.shape} vs "
                             f"{want.dtype}{want.shape}; first diffs {bad})")


# ------------------------------------------------------------------- P0

def p0_device(count: int = 1) -> tuple[dict, str]:
    """Require ``count`` GPUs and the native host library; print what
    the run uses. Returns (device info, card line)."""
    info = device_info()
    require_gpu(info, count)
    card = card_line()
    print(f"P0 card (nvidia-smi name, power.limit): {card}")
    print(f"P0 device: {json.dumps(info)}, jax {jax.__version__}, "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, compile cache "
          f"{jax.config.jax_compilation_cache_dir!r}")
    if native_host.get_lib() is None:
        raise SystemExit("P0: the native host library did not load "
                         "(g++ build of native/sprintz_host.cpp failed, or "
                         "SPRINTZ_NO_NATIVE is set)")
    print(f"P0 native host library: {native_host.lib_path}, "
          f"-march=native {native_host.march_native}", flush=True)
    return info, card.splitlines()[0]


# ------------------------------------------------------------------- P1

def p1_vectors(rep: Report, vec_dir: pathlib.Path = VECTORS) -> None:
    """Encode each reference-produced vector on the device: the stream
    must equal the reference's bytes, and decoding those bytes must
    return the input."""
    manifest = json.loads((vec_dir / "manifest.json").read_text())
    for v in manifest:
        dt = np.uint8 if v["elem_sz"] == 1 else np.uint16
        data = np.fromfile(vec_dir / f"{v['name']}.in", dtype=dt)
        ref = (vec_dir / f"{v['name']}.sprintz").read_bytes()
        got = sprintz_jax.compress(data, codec=v["codec"], ndims=v["ndims"])
        if got != ref:
            raise AssertionError(f"P1 vector {v['name']}: stream differs "
                                 f"from the reference bytes")
        check_equal(sprintz_jax.decompress(ref, codec=v["codec"],
                                           elem_sz=v["elem_sz"]),
                    data, f"P1 vector {v['name']} decode")
        rep.item("P1", f"vector {v['name']}", bytes=len(ref))


def p1_golden(rep: Report, codec: str, elem_sz: int, ndims: int,
              nelems: int, seed: int) -> None:
    """The device codec's stream equals the scalar golden codec's bytes
    and decodes back to the input (random walk with flat stretches and a
    ragged tail)."""
    dt = np.uint8 if elem_sz == 1 else np.uint16
    x = walk(seed, nelems * elem_sz, ndims, dt, runs=True, extra=ndims // 2)
    want = SprintzCodec(codec, elem_sz, backend="golden").compress(x, ndims)
    codec_obj = SprintzCodec(codec, elem_sz)
    got = codec_obj.compress(x, ndims)
    if got != want:
        raise AssertionError(f"P1 golden {codec} u{8 * elem_sz} d{ndims}: "
                             f"stream differs from the golden codec")
    check_equal(codec_obj.decompress(got), x,
                f"P1 golden {codec} u{8 * elem_sz} d{ndims} decode")
    rep.item("P1", f"golden {codec} u{8 * elem_sz} d{ndims}",
             elems=x.size, bytes=len(got))


GOLDEN_GRID = [(c, e, d) for c in ("delta", "xff") for e in (1, 2)
               for d in (1, 3, 18, 64)]


# ------------------------------------------------------------------- P2

def roundtrip(rep: Report, label: str, codec: SprintzCodec,
              x: np.ndarray) -> bytes:
    """compress + decompress through ``codec``, timed twice each."""
    buf, enc1, enc2 = twice(lambda: codec.compress(x))
    out, dec1, dec2 = twice(lambda: codec.decompress(buf))
    check_equal(out, x, f"P2 {label}")
    rep.item("P2", label, bytes_in=x.nbytes, ratio=x.nbytes / len(buf),
             encode_first_s=enc1, encode_warm_s=enc2, decode_first_s=dec1,
             decode_warm_s=dec2)
    return buf


def p2_archive(rep: Report, nbytes: int, seed: int) -> None:
    """d64 u16 delta cold archive (the tiled decode, CHUNK_OUT_BYTES)."""
    x = walk(seed, nbytes, 64, np.uint16)
    roundtrip(rep, f"d64 u16 delta {nbytes} B", SprintzCodec("delta", 2), x)


def p2_query(rep: Report, nbytes: int, seed: int) -> None:
    """d64 u8 delta round trip, then sum/max/min pushdown vs numpy."""
    x = walk(seed, nbytes, 64, np.uint8)
    buf = roundtrip(rep, f"d64 u8 delta {nbytes} B", SprintzCodec("delta", 1),
                    x)
    want = {"sum": x.sum(axis=0, dtype=np.int64), "max": x.max(axis=0),
            "min": x.min(axis=0)}
    for name, op in (("sum", Operation.REDUCE_SUM),
                     ("max", Operation.REDUCE_MAX),
                     ("min", Operation.REDUCE_MIN)):
        res, t1, t2 = twice(lambda: query(
            buf, QueryParams(op=op, materialize=False), codec="delta",
            elem_sz=1))
        check_equal(getattr(res, name), want[name], f"P2 query {name}")
        rep.item("P2", f"query {name} d64 u8 {nbytes} B", first_s=t1,
                 warm_s=t2)


def p2_fire(rep: Report, par_bytes: int, serial_bytes: int,
            seed: int) -> None:
    """FIRE d64 u8: sidecar-parallel decode, and the serial decode."""
    codec = SprintzCodec("xff", 1)
    x = walk(seed, par_bytes, 64, np.uint8)
    (buf, sc), enc1, enc2 = twice(lambda: codec.compress_seekable(x))
    out, dec1, dec2 = twice(lambda: codec.decompress(buf, sidecar=sc))
    check_equal(out, x, "P2 xff sidecar")
    rep.item("P2", f"d64 u8 xff sidecar {par_bytes} B", bytes_in=x.nbytes,
             ratio=x.nbytes / len(buf), encode_first_s=enc1,
             encode_warm_s=enc2, decode_first_s=dec1, decode_warm_s=dec2,
             checkpoints=len(sc.byte_offsets))
    xs = walk(seed + 1, serial_bytes, 64, np.uint8)
    roundtrip(rep, f"d64 u8 xff serial {serial_bytes} B", codec, xs)


def p2_corpus(rep: Report, nbytes: int, seed: int) -> None:
    """The five corpus profiles at u8/u16 x delta/xff (lowdim, mid-D and
    runs paths that d64 never touches)."""
    for name, prof in CORPUS_PROFILES.items():
        for elem_sz in (1, 2):
            dt = np.uint8 if elem_sz == 1 else np.uint16
            rows = nbytes // (prof["ndims"] * elem_sz)
            x = synthetic_corpus(name, nrows=rows, dtype=dt, seed=seed)
            for codec in ("delta", "xff"):
                roundtrip(rep, f"{name} d{prof['ndims']} u{8 * elem_sz} "
                          f"{codec} {x.nbytes} B",
                          SprintzCodec(codec, elem_sz), x)


def p2_huf(rep: Report, nbytes: int, seed: int) -> None:
    """+Huf on d64 u8: decode through 'auto' (the native host loop, the
    faster route on the card) and through huff_decompress(backend='jax'),
    which must run the device decode."""
    codec = SprintzCodec("delta", 1, entropy="huffman")
    x = walk(seed, nbytes, 64, np.uint8)
    buf, enc1, enc2 = twice(lambda: codec.compress(x))
    if not hf.is_container(buf):
        raise AssertionError("P2 +Huf: the stream was stored, not coded")
    out, dec1, dec2 = twice(lambda: codec.decompress(buf))
    check_equal(out, x, "P2 +Huf auto decode")
    plain = SprintzCodec("delta", 1).compress(x)
    device_calls = []
    real = hf._decode_jax

    def counted(*args):
        device_calls.append(1)
        return real(*args)

    hf._decode_jax = counted
    try:
        sym, j1, j2 = twice(lambda: hf.huff_decompress(buf, backend="jax"))
    finally:
        hf._decode_jax = real
    check_equal(sym, np.frombuffer(plain, np.uint8), "P2 +Huf jax decode")
    if len(device_calls) != 2:
        raise AssertionError(f"P2 +Huf: backend='jax' ran the device "
                             f"decode {len(device_calls)} of 2 times")
    rep.item("P2", f"+Huf d64 u8 delta {nbytes} B", bytes_in=x.nbytes,
             ratio=x.nbytes / len(buf), encode_first_s=enc1,
             encode_warm_s=enc2, auto_decode_first_s=dec1,
             auto_decode_warm_s=dec2, jax_huff_first_s=j1,
             jax_huff_warm_s=j2)


def p2_batch(rep: Report, nstreams: int, stream_bytes: int,
             seed: int) -> None:
    """compress_batch / decompress_batch over many short d64 u8 streams."""
    codec = SprintzCodec("delta", 1)
    x = walk(seed, nstreams * stream_bytes, 64, np.uint8)
    arrays = list(x.reshape(nstreams, -1, 64))
    bufs, enc1, enc2 = twice(lambda: codec.compress_batch(arrays))
    outs, dec1, dec2 = twice(lambda: codec.decompress_batch(bufs))
    for i, (a, o) in enumerate(zip(arrays, outs)):
        check_equal(o, a, f"P2 batch stream {i}")
    if bufs[0] != codec.compress(arrays[0]):
        raise AssertionError("P2 batch: stream 0 differs from compress()")
    rep.item("P2", f"batch {nstreams} x {stream_bytes} B d64 u8 delta",
             encode_first_s=enc1, encode_warm_s=enc2, decode_first_s=dec1,
             decode_warm_s=dec2)


# ------------------------------------------------------------------- P3

def p3_multi(rep: Report, n_dev: int, archive_bytes: int, fire_bytes: int,
             seed: int) -> None:
    """Sharded encode/decode over an n_dev mesh, checked against the
    single-device encoder and the input."""
    from sprintz_jax.parallel import shard

    mesh = shard.make_mesh(n_dev)
    x = walk(seed, archive_bytes, 64, np.uint16).reshape(-1)
    multi, m1, m2 = twice(lambda: shard.dp_compress(mesh, x, 64, "delta"))
    single = encoder.compress(x, 64, codec="delta")
    if multi != single:
        raise AssertionError("P3 dp_compress: not byte-identical to "
                             "encoder.compress")
    out, d1, d2 = twice(lambda: shard.dp_decompress(mesh, multi, "delta", 2))
    check_equal(out, x, "P3 dp_decompress delta u16")
    rep.item("P3", f"dp_compress/dp_decompress d64 u16 delta {x.nbytes} B "
             f"on {n_dev} devices", encode_first_s=m1, encode_warm_s=m2,
             decode_first_s=d1, decode_warm_s=d2)

    xf = walk(seed + 1, fire_bytes, 64, np.uint8)
    buf, sc = SprintzCodec("xff", 1).compress_seekable(xf)
    outf, f1, f2 = twice(lambda: shard.dp_decompress(
        mesh, buf, "xff", 1, sidecar=sc))
    check_equal(outf, xf, "P3 dp_decompress xff sidecar")
    rep.item("P3", f"dp_decompress d64 u8 xff sidecar {xf.nbytes} B on "
             f"{n_dev} devices", first_s=f1, warm_s=f2)

    # +Huf stage over the sharded stream, decoded back through the
    # sharded decoder (the path of __graft_entry__.dryrun_multichip)
    payload = np.frombuffer(multi, np.uint8)
    comp = hf.huff_compress(payload, chunk_symbols=128, allow_stored=False)
    back = hf.huff_decompress(comp)
    check_equal(back, payload, "P3 +Huf round trip")
    out4 = shard.dp_decompress(mesh, back.tobytes(), "delta", 2)
    check_equal(out4, x, "P3 +Huf -> dp_decompress")
    rep.item("P3", f"+Huf -> dp_decompress {len(comp)} B on {n_dev} devices")


# ------------------------------------------------------------------ main

def ok_line(info: dict) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="run P0 on four cards and the sharded phase P3 "
                         "only")
    args = ap.parse_args(argv)
    enable_compile_cache()
    info, card = p0_device(4 if args.multi else 1)
    rep = Report(card)
    t0 = time.perf_counter()
    if args.multi:
        p3_multi(rep, 4, MULTI_SIZES["archive_u16"], MULTI_SIZES["fire_par"],
                 args.seed)
    else:
        s = SIZES
        p1_vectors(rep)
        for i, (codec, elem_sz, ndims) in enumerate(GOLDEN_GRID):
            p1_golden(rep, codec, elem_sz, ndims, s["golden_elems"],
                      args.seed + i)
        p2_archive(rep, s["archive_u16"], args.seed)
        p2_query(rep, s["query_u8"], args.seed)
        p2_fire(rep, s["fire_par"], s["fire_serial"], args.seed)
        p2_corpus(rep, s["corpus"], args.seed)
        p2_huf(rep, s["huf"], args.seed)
        p2_batch(rep, s["batch_streams"], s["batch_bytes"], args.seed)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    print(ok_line(info), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
