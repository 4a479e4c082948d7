"""Tracing / profiling utilities.

The reference's only tooling is an rdtsc timer (test/timing_utils.hpp).
Equivalents here:

- ``Timer`` / ``timed``: wall-clock section timing with a structured
  report (the EasyTimer analogue).
- ``device_profile``: wraps a callable in a JAX profiler trace whose
  dump can be opened in XProf/TensorBoard.
- ``annotate``: named TraceAnnotation context for framing regions inside
  profiles.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Timer:
    """Accumulating section timer (EasyTimer analogue, timing_utils.hpp:60)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{name:30s} {self.totals[name] * 1e3:10.2f} ms "
                 f"({self.counts[name]}x)"
                 for name in sorted(self.totals, key=self.totals.get,
                                    reverse=True)]
        return "\n".join(lines)


@contextlib.contextmanager
def device_profile(logdir: str):
    """Capture a JAX device profile around a code region.

    Open the dump with XProf / TensorBoard's profile plugin."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named annotation visible in device traces."""
    import jax

    return jax.profiler.TraceAnnotation(name)
