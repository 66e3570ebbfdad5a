"""Helpers shared by the scripts that run on the GPU (``bench.py``,
``chip_smoke.py``): the device check, the persistent compile cache, the
card's name and power limit, and peak device memory."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


class NoGPUError(RuntimeError):
    """Raised when JAX finds no GPU: these scripts never fall back."""


def use_compile_cache() -> str:
    """Enable JAX's persistent compile cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache goes to a fixed
    ``<checkout>/.jax_cache`` (the path is part of the cache key, so a
    moving directory would never hit)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """Return ``jax.devices()`` if they are GPUs; raise NoGPUError otherwise."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:  # a requested platform failed to start
        raise NoGPUError(f"JAX found no usable backend: {e}") from e
    if devices[0].platform != "gpu":
        raise NoGPUError(
            f"no GPU: JAX's default device is {devices[0].platform!r} "
            f"({devices[0].device_kind})"
        )
    return devices


def device_record(devices) -> dict:
    """The device as JAX reports it."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the cards, one per line.

    Runs as a child process that never imports JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return r.stdout.strip() if r.returncode == 0 else f"nvidia-smi failed: {r.stderr.strip()}"


def peak_bytes(device) -> int | None:
    """``peak_bytes_in_use`` of one device (None where not reported)."""
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")
