"""Vectorized intersection primitives shared by the oracle and the kernels.

Replicates the numerical semantics of:
- Triangle::intersect (Möller–Trumbore, reference/sources/mesh.cpp:23-62)
- AABB::intersect (slab test, reference/sources/bvh.cpp:40-66)

Each test exists in two spellings with ONE operation order: the ``*_xyz``
form takes 3-vectors as (x, y, z) tuples of same-shape arrays — the form a
GPU kernel block can hold, since its tensors have power-of-two shapes — and
the ``[..., 3]`` form unpacks its operands and calls it.  The XLA traversal
and the Pallas kernel therefore run the same arithmetic lane for lane.

NaN handling matters for bit parity: C's ``a < b ? a : b`` returns ``b`` when
either operand is NaN, unlike jnp.minimum (which propagates NaN); ``c_min`` /
``c_max`` replicate the C ternary so degenerate rays (axis-parallel, origin on
a slab plane) behave identically.
"""

from __future__ import annotations

import jax.numpy as jnp

from .vecmath import F32_EPSILON, F32_FAR_AWAY


def c_min(a, b):
    return jnp.where(a < b, a, b)


def c_max(a, b):
    return jnp.where(a > b, a, b)


def xyz(a):
    """Split a [..., 3] array into its (x, y, z) components."""
    return a[..., 0], a[..., 1], a[..., 2]


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1], a[2] - b[2]


def intersect_triangle_xyz(origin, direction, v0, v1, v2, t_max):
    """Möller–Trumbore over (x, y, z) component tuples; see
    ``intersect_triangle``."""
    e1 = _sub(v1, v0)
    e2 = _sub(v2, v0)
    h = _cross(direction, e2)
    a = _dot(e1, h)
    det_ok = jnp.abs(a) >= F32_EPSILON
    f = jnp.float32(1.0) / a
    s = _sub(origin, v0)
    u = f * _dot(s, h)
    q = _cross(s, e1)
    v = f * _dot(direction, q)
    t = f * _dot(e2, q)
    hit = (
        det_ok
        & (u >= jnp.float32(0.0))
        & (u <= jnp.float32(1.0))
        & (v >= jnp.float32(0.0))
        & (u + v <= jnp.float32(1.0))
        & (t >= F32_EPSILON)
        & (t < t_max)
    )
    return hit, t, u, v


def intersect_triangle(origin, direction, v0, v1, v2, t_max):
    """Möller–Trumbore over broadcastable [..., 3] operands.

    Returns (hit, t, u, v); ``hit`` is False where |det| < F32_EPSILON, the
    barycentrics leave [0, 1], or t is outside [F32_EPSILON, t_max)
    (mesh.cpp:23-62, depthInBounds surf_math.h:229).
    """
    return intersect_triangle_xyz(xyz(origin), xyz(direction), xyz(v0),
                                  xyz(v1), xyz(v2), t_max)


def intersect_aabb_xyz(origin, inv_direction, bb_min, bb_max, t_max):
    """Slab test over (x, y, z) component tuples; see ``intersect_aabb``."""
    t_near = [(bb_min[k] - origin[k]) * inv_direction[k] for k in range(3)]
    t_far = [(bb_max[k] - origin[k]) * inv_direction[k] for k in range(3)]

    tmin = c_min(t_near[0], t_far[0])
    tmax = c_max(t_near[0], t_far[0])
    tmin = c_max(tmin, c_min(t_near[1], t_far[1]))
    tmax = c_min(tmax, c_max(t_near[1], t_far[1]))
    tmin = c_max(tmin, c_min(t_near[2], t_far[2]))
    tmax = c_min(tmax, c_max(t_near[2], t_far[2]))

    ok = (tmax >= tmin) & (tmin < t_max) & (tmax > jnp.float32(0.0))
    return jnp.where(ok, tmin, F32_FAR_AWAY)


def intersect_aabb(origin, inv_direction, bb_min, bb_max, t_max):
    """Slab test (bvh.cpp:40-66): returns entry distance tmin where the AABB
    is hit before ``t_max``, else F32_FAR_AWAY."""
    return intersect_aabb_xyz(xyz(origin), xyz(inv_direction), xyz(bb_min),
                              xyz(bb_max), t_max)
