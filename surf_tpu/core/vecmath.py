"""Vectorized 3-vector math on [..., 3] jnp arrays.

TPU-native replacement for the reference's scalar Float3 class
(/root/reference/headers/surf_math.h:25-201): every op is elementwise over a
lane axis so the VPU vectorizes it for free.

World basis constants replicate /root/reference/headers/camera.h:7-9
(left-handed: forward = -z is the *constant*, but note the camera constructs
its own basis from target - position).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# NumPy scalars, not device arrays: importing this module touches no
# backend, and a kernel body may close over them as literals.
F32_FAR_AWAY = np.float32(1e30)    # surf_math.h:17
F32_EPSILON = np.float32(1e-5)     # surf_math.h:18
F32_PI = np.float32(3.14159265358979323846264)
F32_INV_PI = np.float32(0.31830988618379067153777)
F32_2PI = np.float32(6.28318530717958647692528)

WORLD_FORWARD = jnp.array([0.0, 0.0, -1.0], dtype=jnp.float32)  # camera.h:7
WORLD_RIGHT = jnp.array([1.0, 0.0, 0.0], dtype=jnp.float32)     # camera.h:8
WORLD_UP = jnp.array([0.0, 1.0, 0.0], dtype=jnp.float32)        # camera.h:9


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Row-wise dot product over the trailing xyz axis."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def normalize(a: jnp.ndarray) -> jnp.ndarray:
    """normalize via rsqrt like Float3::normalize (surf_math.h:197-199)."""
    inv_len = jnp.float32(1.0) / jnp.sqrt(dot(a, a))
    return a * inv_len[..., None]


def reflect(direction: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """reflect (surf_math.h:227): d - 2 (n.d) n."""
    return direction - jnp.float32(2.0) * dot(normal, direction)[..., None] * normal


def radians(deg) -> jnp.ndarray:
    """radians (surf_math.h:233): deg * pi * 0.005555555555555f — replicate
    the reference's slightly-truncated 1/180 constant."""
    return (jnp.float32(deg) * F32_PI) * jnp.float32(0.005555555555555)
