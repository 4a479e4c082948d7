"""The device a measurement or smoke run is on, and the card behind it.

Every result that names a device names it the way JAX reports it
(``platform``, ``device_kind``, device count); a run that needs the GPU
fails when JAX's platform is anything else, rather than report a CPU
number under a device name.
"""

from __future__ import annotations

import subprocess


def device_info() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's default devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(info: dict, count: int = 1) -> None:
    """Exit with an error unless ``info`` shows at least ``count`` GPUs."""
    if info["platform"] != "gpu":
        raise SystemExit(
            f"needs a GPU; JAX's platform is {info['platform']!r} "
            f"({info['kind']})")
    if info["count"] < count:
        raise SystemExit(f"needs {count} GPUs; JAX sees {info['count']}")


def card_line() -> str:
    """``name, power.limit`` of each card, as nvidia-smi prints them.

    Runs nvidia-smi as a child process that never touches JAX, so it
    cannot open the card a second time."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip()
