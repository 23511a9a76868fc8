"""Platform helpers shared by the entry points (CLI, bench, chip smoke)."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

# <checkout>/.jax_cache: a fixed path, so repeated runs in one checkout hit.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing; otherwise the cache goes to ``DEFAULT_CACHE_DIR``."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def require_gpu():
    """The default JAX devices if they are GPUs; raises otherwise (a
    measurement never falls back to the CPU)."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default platform is {devices[0].platform!r}")
    return devices


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card, e.g.
    ``NVIDIA H200, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def force_cpu(virtual_devices: int | None = None) -> None:
    """Force the CPU backend (optionally with N virtual devices).

    Must run before any array is created on the target backend."""
    if virtual_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={virtual_devices}"
            ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    try:
        from jax.extend.backend import clear_backends

        clear_backends()
    except Exception:
        pass
