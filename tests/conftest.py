"""Test configuration: the CPU backend with 8 virtual devices, so sharding
logic is testable without several cards (SURVEY.md §4).  The config update
also covers the case where JAX_PLATFORMS names another platform.  Tests keep
no persistent compile cache (the CLI entry point would otherwise turn one
on)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)
try:
    from jax.extend.backend import clear_backends

    clear_backends()
except Exception:
    pass
