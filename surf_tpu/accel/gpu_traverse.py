"""Per-block BVH traversal kernel for NVIDIA GPUs (Pallas, Triton route).

The reference's GPU extend/connect stages give each thread one ray that
walks the BVH and stops on its own (shaders/ray_extend.comp:26-165,
ray_connect.comp:178-212).  This kernel is that shape in Pallas: each
program owns BLOCK_RAYS rays held as SoA columns (one ray per thread), and
runs the skip-link walk of ``accel/traverse.py`` — the same ``walk_step``,
so the same operations in the same order — until its own rays finish.  The
node and triangle tables are read with per-lane gathers; at the scene sizes
the renderer runs they stay resident in the card's L2.

Against the XLA walk (``traverse.traverse``), which steps every lane of the
frame in lockstep until the slowest lane finishes, with a few kernel
launches and a predicate readback per step, the kernel launches once per
call and no block waits for rays of another.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.geometry import xyz
from .traverse import Hit, TraceArrays, walk_done, walk_init, walk_step

# Rays per program and warps per program: one ray per thread.
BLOCK_RAYS = 64
NUM_WARPS = BLOCK_RAYS // 32


def _kernel(ox, oy, oz, dx, dy, dz, tmax, act, boxes, meta, v0, v1, v2,
            prim_out, t_out, u_out, v_out, *, any_hit: bool, n_tris: int):
    end = jnp.int32(boxes.shape[0])
    o = (ox[...], oy[...], oz[...])
    d = (dx[...], dy[...], dz[...])
    inv_dir = tuple(jnp.float32(1.0) / c for c in d)

    def fetch_tri(slot):
        return tuple((r[slot, 0], r[slot, 1], r[slot, 2]) for r in (v0, v1, v2))

    def fetch_node(node):
        return ((boxes[node, 0], boxes[node, 1], boxes[node, 2]),
                (boxes[node, 3], boxes[node, 4], boxes[node, 5]),
                meta[node, 0], meta[node, 1], meta[node, 2])

    def running(s):
        # any lane of this block not done (Triton lowers max, not any)
        return jnp.max((~walk_done(s, end)).astype(jnp.int32)) > 0

    s = jax.lax.while_loop(
        running,
        lambda s: walk_step(s, o, d, inv_dir, end, n_tris, fetch_tri,
                            fetch_node, any_hit),
        walk_init(tmax[...], act[...] != 0, end))
    prim_out[...] = s.best_prim
    t_out[...] = s.best_t
    u_out[...] = s.best_u
    v_out[...] = s.best_v


@partial(jax.jit, static_argnames=("any_hit", "interpret"))
def traverse_gpu(arrays: TraceArrays, origin, direction, t_max, active,
                 any_hit: bool = False, *, interpret: bool = False) -> Hit:
    """Drop-in for ``traverse.traverse``: same arguments, same ``Hit``.

    ``interpret=True`` runs the kernel body through the Pallas interpreter
    (CPU tests); nothing sets it implicitly."""
    n = origin.shape[0]
    pad = -n % BLOCK_RAYS
    cols = [*xyz(origin), *xyz(direction), t_max.astype(jnp.float32),
            active.astype(jnp.int32)]
    if pad:
        # padded lanes are inactive: they start done and are cut off below
        cols = [jnp.pad(c, (0, pad)) for c in cols]
    n_pad = n + pad
    lane = pl.BlockSpec((BLOCK_RAYS,), lambda i: (i,))
    tables = (arrays.node_boxes, arrays.node_meta, arrays.tri_v0,
              arrays.tri_v1, arrays.tri_v2)
    out = pl.pallas_call(
        partial(_kernel, any_hit=any_hit, n_tris=arrays.tri_v0.shape[0]),
        out_shape=tuple(
            jax.ShapeDtypeStruct((n_pad,), dt)
            for dt in (jnp.int32, jnp.float32, jnp.float32, jnp.float32)),
        grid=(n_pad // BLOCK_RAYS,),
        in_specs=[lane] * 8 + [
            pl.BlockSpec(t.shape, lambda i, nd=t.ndim: (0,) * nd)
            for t in tables],
        out_specs=[lane] * 4,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_traverse_anyhit" if any_hit else "bvh_traverse_closest",
    )(*cols, *tables)
    prim, t, u, v = (x[:n] for x in out)
    return Hit(prim=prim, t=t, u=u, v=v)
