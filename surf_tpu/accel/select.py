"""The one place that picks the BVH traversal for a platform."""

from __future__ import annotations

import jax

from .traverse import traverse


def default_platform() -> str:
    """Platform of the device computations run on by default: the device
    set by ``jax.default_device`` if any, else ``jax.devices()[0]``."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.devices()[0].platform
    return dev if isinstance(dev, str) else dev.platform


def traversal_for(platform: str):
    """The traversal function for ``platform``: the Pallas kernel on
    ``"gpu"``, the XLA walk on ``"cpu"``.  Both take
    ``(arrays, origin, direction, t_max, active, any_hit=...)`` and return
    the same ``Hit``."""
    if platform == "gpu":
        from .gpu_traverse import traverse_gpu

        return traverse_gpu
    if platform == "cpu":
        return traverse
    raise ValueError(f"no BVH traversal for platform {platform!r} "
                     "(supported: gpu, cpu)")
