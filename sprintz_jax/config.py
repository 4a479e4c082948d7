"""Central registry for every ``SPRINTZ_*`` knob (VERDICT r3 item 9).

One declarative table: name, type, default, choices, WHEN the value is
read, and the evidence that set the default.
``docs/CONFIG.md`` is generated from this table (``python -m
sprintz_jax.config``) so the docs cannot drift from the code.

Read-time semantics (the column that bites):

- ``import``: parsed once when ``sprintz_jax.config`` is imported. The
  owning module mirrors the value into a module global (kept so tests
  can monkeypatch e.g. ``ops.pack.MXU_IMPL`` per-case); setting the env
  var later in the same process has no effect.
- ``trace``: like ``import``, but the value is baked into jitted
  programs at first trace — after changing the module global you must
  also ``jax.clear_caches()`` or the old behavior persists in cache.
- ``call``: read from ``os.environ`` fresh on every use (safe to set
  mid-process; what ``monkeypatch.setenv`` tests rely on).

Validation: at import, any environment variable starting with
``SPRINTZ_`` that is not declared here raises ``UnknownKnobWarning``
(a typo'd knob silently doing nothing is the failure mode this
registry exists to prevent), and declared values are checked against
``choices``/type with a hard ``ValueError``.

The reference has no equivalent (its knobs are compile-time #defines
scattered through cpp/Compress); SURVEY §5 prescribed a real config
object for the rebuild.
"""

from __future__ import annotations

import dataclasses
import os
import warnings


class UnknownKnobWarning(UserWarning):
    """An SPRINTZ_* env var is set but not declared in the registry."""


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str  # full env var name, SPRINTZ_*
    default: object
    kind: str  # "import" | "trace" | "call"
    type: str  # "str" | "int" | "flag" (flag: "1" = on)
    help: str
    owner: str  # module that consumes it (module global of same suffix)
    choices: tuple | None = None
    evidence: str = ""  # what set the default


_K = Knob

# Evidence of the defaults that an A/B on the previous accelerator chose;
# none of them has been re-measured on the H100 yet (ROADMAP Queue 3).
_PRIOR = "earlier-device A/B; H100 not measured"
KNOBS: dict[str, Knob] = {k.name: k for k in [
    # ---------------------------------------------------------- ops/pack
    _K("SPRINTZ_MXU_IMPL", "bf16", "trace", "str",
       "Number format for the batched unpack/pack one-hot matmuls: bf16 "
       "(exact for <=16-bit fields via 3-byte windows), s8 (biased "
       "int8 dot), or bf3 (shifted-payload: ONE byte-select one-hot — "
       "single compare instead of the 3-level where chain — with "
       "byte-shifted payload copies on the dot's M axis).",
       "ops.pack.MXU_IMPL", ("bf16", "s8", "bf3"), _PRIOR),
    _K("SPRINTZ_UNPACK_NWIN", "auto", "trace", "str",
       "Byte-window count for the rowmajor (un)pack matmuls: auto (2 "
       "windows for u8 streams — fields stop at (off&7)+width <= 15 "
       "bits, so the 65536 window is provably zero — 3 for u16), 3 "
       "forces the conservative 3-window form, 2 is accepted but still "
       "clamps u16 call sites to 3 (2 windows can never be valid "
       "there).", "ops.pack.UNPACK_NWIN", ("auto", "2", "3"), _PRIOR),
    _K("SPRINTZ_UNPACK_PAIR", "0", "trace", "flag",
       "Paired-dim u8 unpack/pack (one 3-byte matmul window per dim "
       "PAIR, halving the weight tensor). Exact; off by default.",
       "ops.pack.UNPACK_PAIR", None, _PRIOR),
    _K("SPRINTZ_UNPACK_WLAYOUT", "auto", "trace", "str",
       "Rowmajor unpack formulation: auto (wordsel when maxb==8, "
       "one-hot matmul otherwise), transpose (matmul always), dot "
       "(weight built in dot-operand layout), wordsel (matmul-free "
       "select+funnel shift).",
       "ops.pack.UNPACK_WLAYOUT", ("auto", "transpose", "dot", "wordsel"),
       _PRIOR),
    _K("SPRINTZ_LOWDIM_IMPL", "auto", "trace", "str",
       "Lowdim (un)pack formulation: auto (unpack: jsel for u8 D<=4 "
       "legacy-shape calls, einsum otherwise; pack: einsum), einsum "
       "(per-block one-hot dot), einsum2 (EB-major weights), select "
       "(select-accumulate), wselect (width-stratified static shifts), "
       "dyn (variable shifts), wbank (static width-bank weight + "
       "per-width select), jsel (fused EB-way static selects), wsel32 "
       "(word-granular 2-deep select + funnel).",
       "ops.pack.LOWDIM_IMPL",
       ("auto", "einsum", "einsum2", "select", "wselect", "dyn",
        "wbank", "jsel", "wsel32"), _PRIOR),
    # ----------------------------------------------------------- decoder
    _K("SPRINTZ_LOWDIM_PASS", "auto", "trace", "str",
       "Fused lowdim delta decode pass: auto (grouped when 128%D==0, "
       "else legacy), grouped (force the flat-scatter grouped runs "
       "path too), dmajor, legacy.", "decoder.LOWDIM_PASS",
       ("auto", "grouped", "dmajor", "legacy"), _PRIOR),
    _K("SPRINTZ_GROUPED_FINISH", "v1", "trace", "str",
       "Grouped lowdim prefix finish: v1 (offset add in (c,8,g,D) "
       "minor-D layout) or v2 (full-lane (c,8,g*D) add; g-axis offset "
       "prefix = log2(g) static lane shifts).",
       "decoder.GROUPED_FINISH", ("v1", "v2"), _PRIOR),
    _K("SPRINTZ_LOWDIM_D3", "fold4", "trace", "str",
       "d3 grouped decode fold: fold4 (zero-width 4th dim, d4 pass) "
       "or native (g=42 fold, 126/128 lanes, no fake dim; decode "
       "only — encode always folds as d4).",
       "decoder/ops.pack.LOWDIM_D3", ("fold4", "native"), _PRIOR),
    _K("SPRINTZ_LOWDIM_DMAJOR", "1", "trace", "flag",
       "Dim-major lowdim passes available (encoder pass choice and "
       "decoder dmajor path).", "decoder/encoder.LOWDIM_DMAJOR", None,
       _PRIOR),
    _K("SPRINTZ_LOWDIM_DMAJOR_IMPL", "dyn", "trace", "str",
       "Dim-major pack/unpack formulation: dyn (dynamic shifts) or "
       "strata (width-stratified static shifts).",
       "decoder/encoder.LOWDIM_DMAJOR_IMPL", ("dyn", "strata"), _PRIOR),
    _K("SPRINTZ_RUNS_TIMELINE", "auto", "trace", "str",
       "Runs-stream timeline realization: auto (= gather), gather "
       "(block-gather of unpacked errs), dgather (gather PACKED bytes, "
       "unpack on the timeline), ngather (gather errs NARROWED to elem "
       "width), scatter (legacy row scatter).",
       "decoder.RUNS_TIMELINE",
       ("auto", "gather", "dgather", "ngather", "scatter"), _PRIOR),
    _K("SPRINTZ_ROWMAJOR_FOLD", "0", "trace", "flag",
       "Block-folded rowmajor delta decode (G=128/D blocks -> full-lane "
       "tensors). Exact; opt-in.", "decoder.ROWMAJOR_FOLD", None, _PRIOR),
    _K("SPRINTZ_DECODE_FLAT", "auto", "trace", "str",
       "Flat-param contiguous decode: pass the dense/widths jit params "
       "as 1-D arrays and reshape inside jit. auto = every contiguous "
       "pass, all, 0.", "decoder.DECODE_FLAT", ("auto", "all", "0"),
       _PRIOR),
    _K("SPRINTZ_MAXB_BUCKET", "pow2", "trace", "str",
       "Bucketing of the dense unpack buffer's byte width: pow2 (fewer "
       "jit variants) or mult8 (up to 1.6x smaller weights).",
       "decoder.MAXB_BUCKET", ("pow2", "mult8"), _PRIOR),
    _K("SPRINTZ_RAGGED_DECODE", "", "call", "flag",
       "Ragged-dot unpack over signature-sorted blocks instead of the "
       "per-signature grouped pass. Opt-in.", "decoder._use_ragged()",
       None, _PRIOR),
    _K("SPRINTZ_GROUPED_DECODE", "", "call", "flag",
       "Route runs-containing rowmajor streams through the grouped "
       "width-signature pass instead of the gather timeline. Opt-in.",
       "decoder.decompress", None, _PRIOR),
    # ----------------------------------------------------------- encoder
    _K("SPRINTZ_ENCODE_FLAT", "auto", "trace", "str",
       "Flat-param lowdim delta encode: auto (u8 D in {2,3,4} + u16 "
       "d2), all, 0 (off). Precedence: auto defers to an explicitly "
       "set SPRINTZ_LOWDIM_ENCODE (so pass A/Bs measure the requested "
       "pass); 'all' overrides it.",
       "encoder.ENCODE_FLAT", ("auto", "all", "0"), _PRIOR),
    _K("SPRINTZ_LOWDIM_ENCODE", None, "trace", "str",
       "Lowdim delta encode pass: dmajor (default when "
       "SPRINTZ_LOWDIM_DMAJOR=1), grouped, legacy. Setting this "
       "explicitly also disables the SPRINTZ_ENCODE_FLAT auto-route "
       "(flat still wins with ENCODE_FLAT=all).",
       "encoder.LOWDIM_ENCODE", ("dmajor", "grouped", "legacy"), _PRIOR),
    # ------------------------------------------------- models/forecasters
    _K("SPRINTZ_PREFIX_IMPL", "s8", "trace", "str",
       "Number format for the triangular prefix-sum matmul: s8 "
       "(s8*s8->s32) or bf16 (bf16 operands, f32 accumulation). Both "
       "are exact.", "models.forecasters.PREFIX_IMPL", ("s8", "bf16"),
       _PRIOR),
    _K("SPRINTZ_PREFIX_FOLD", "auto", "trace", "str",
       "Hierarchical cumsum chunk folding.",
       "models.forecasters.PREFIX_FOLD", ("auto", "0", "1"), _PRIOR),
    _K("SPRINTZ_SCAN_UNROLL", "8", "trace", "int",
       "FIRE serial-scan unroll. 8 on every backend: unroll 32 sends "
       "XLA:CPU into a >15-min compile, and on the H100 larger unrolls "
       "multiply every FIRE program's compile time (sweep in PERF.md).",
       "models.forecasters.SCAN_UNROLL", None, "PERF.md"),
    # ------------------------------------------------------------ entropy
    _K("SPRINTZ_HUFF_CHUNK", "4096", "import", "int",
       "Huffman chunk_symbols when huff_compress is given none. 4096: "
       "the native host decode is as fast as at 128 and the stream "
       "~1.9% smaller (PERF.md); 128 gives a chunk-parallel device "
       "decode more lanes. Must fit u16.",
       "entropy.huffman.DEFAULT_CHUNK_SYMBOLS", None, ""),
    # ------------------------------------------------------------- native
    _K("SPRINTZ_NO_NATIVE", "", "call", "flag",
       "Force the pure-Python fallbacks for every native C++ host stage "
       "(plan walk, assembly, Huffman loops).", "native_host", None, ""),
    _K("SPRINTZ_NATIVE_CACHE", None, "call", "str",
       "Directory for the compiled native library (default "
       "$TMPDIR/sprintz_native).", "native_host", None, ""),
    _K("SPRINTZ_NATIVE_MARCH", "1", "call", "flag",
       "Build the native library with -march=native (0 = portable "
       "build).", "native_host", None, ""),
    # --------------------------------------------------------------- data
    _K("SPRINTZ_DATA_DIR", None, "call", "str",
       "Root directory of the benchmark corpora (UCR/AMPDS/PAMAP/...); "
       "unset = the checked-in mini corpus.", "data.corpus/loaders",
       None, ""),
    # -------------------------------------------------------- bench/tests
    _K("SPRINTZ_BENCH_EXTRAS", "1", "call", "flag",
       "bench.py: run the per-config context measurements.", "bench.py",
       None, ""),
    _K("SPRINTZ_BENCH_HUFF_CHUNK", "128", "call", "int",
       "bench.py: chunk_symbols for the Huffman kernel rows.",
       "bench.py", None, ""),
    _K("SPRINTZ_BENCH_FIRE", "", "call", "flag",
       "bench.py: add the raw FIRE-lanes context row.", "bench.py",
       None, ""),
    _K("SPRINTZ_BENCH_XFFBATCH", "", "call", "flag",
       "bench.py: add the batched multi-stream xff encode row "
       "(compress_batch operating point).", "bench.py", None, ""),
    _K("SPRINTZ_REF_LIB", "/tmp/refbuild/libsprintz_ref.so", "call",
       "str", "Path of the compiled reference oracle library "
       "(tests/oracle.py).", "tests.oracle", None, ""),
    _K("SPRINTZ_FUZZ_SEED", None, "import", "int",
       "Differential fuzz seed (default: fresh entropy per run).",
       "tests.test_differential", None, ""),
    _K("SPRINTZ_FUZZ_CASES", "6", "import", "int",
       "Differential fuzz cases per config.", "tests.test_differential",
       None, ""),
]}


def _parse(k: Knob, raw: str):
    if k.type == "int":
        try:
            return int(raw)
        except ValueError:
            raise ValueError(
                f"{k.name}={raw!r}: expected an integer") from None
    if k.choices is not None and raw not in k.choices:
        raise ValueError(
            f"{k.name}={raw!r}: expected one of {list(k.choices)}")
    return raw


def validate_environ(environ=None) -> None:
    """Warn on undeclared SPRINTZ_* vars; raise on invalid values."""
    environ = os.environ if environ is None else environ
    for name, raw in environ.items():
        if not name.startswith("SPRINTZ_"):
            continue
        k = KNOBS.get(name)
        if k is None:
            warnings.warn(
                f"unknown knob {name} is set (not in "
                "sprintz_jax.config.KNOBS — typo?)", UnknownKnobWarning,
                stacklevel=2)
        else:
            _parse(k, raw)


def get(name: str, default=None):
    """Fresh (call-time) read of a declared knob, parsed and validated."""
    k = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None:
        if default is not None:
            return default
        if isinstance(k.default, str) and k.type == "int":
            return int(k.default)
        return k.default
    return _parse(k, raw)


def flag(name: str) -> bool:
    """Fresh read of a flag knob ('1' = on)."""
    KNOBS[name]  # declared?
    return os.environ.get(name) == "1"


def markdown() -> str:
    """The docs/CONFIG.md body (generated; see this module's docstring)."""
    lines = [
        "# Configuration knobs",
        "",
        "Every `SPRINTZ_*` environment variable, generated from",
        "`sprintz_jax/config.py` (`python -m sprintz_jax.config >",
        "docs/CONFIG.md`). Undeclared `SPRINTZ_*` vars raise",
        "`UnknownKnobWarning` at import; invalid values raise",
        "`ValueError`.",
        "",
        "**Read column**: `import` = parsed once at package import;",
        "`trace` = additionally baked into jitted programs at first",
        "trace (change the module global AND `jax.clear_caches()`);",
        "`call` = read fresh on every use.",
        "",
        "| Knob | Default | Read | Values | Owner | What / evidence |",
        "|---|---|---|---|---|---|",
    ]
    for k in KNOBS.values():
        choices = "/".join(k.choices) if k.choices else (
            "0/1" if k.type == "flag" else k.type)
        ev = f" *({k.evidence})*" if k.evidence else ""
        default = "unset" if k.default in (None, "") else str(k.default)
        lines.append(
            f"| `{k.name}` | `{default}` | {k.kind} | {choices} "
            f"| `{k.owner}` | {k.help}{ev} |")
    lines.append("")
    return "\n".join(lines)


validate_environ()

if __name__ == "__main__":
    print(markdown())
