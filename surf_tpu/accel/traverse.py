"""Stackless skip-link BVH traversal — the `ray_extend`/`ray_connect` core.

Redesign of the reference's per-thread stackful traversal
(reference/sources/bvh.cpp:129-253 CPU, shaders/ray_extend.comp:26-165 GPU).
Nodes are laid out in DFS preorder with a per-node *skip link* (the DFS
position of the next subtree), so a lane's whole control state is one index
plus a leaf cursor: no per-lane stack.  Each step a lane either tests one
triangle of the leaf it is in, or visits its current node (descend on a box
hit, else jump to the skip link).  Hit selection (strictly-closer wins,
mesh.cpp:56) is order-independent, so results equal the stack walk's modulo
exact-t ties.

``walk_step`` is the one definition of a step.  ``traverse`` drives it for
all N lanes in lockstep under ``lax.while_loop`` (the XLA walk, used on the
CPU and as the reference); ``accel/gpu_traverse.py`` drives the same step
inside a Pallas kernel, one block of rays per program, each block stopping
when its own rays finish.

Layout notes:
- triangles are pre-permuted into leaf order at scene-compile time, so a
  leaf is a contiguous [first, first+count) range and the cursor doubles as
  the triangle id (the reference's indices[] indirection is folded away);
- boxes+meta are row-gathered per visited node: [D, 6] f32 and [D, 3] i32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.geometry import intersect_aabb_xyz, intersect_triangle_xyz, xyz
from .builder import BVH


class TraceArrays(NamedTuple):
    """Device-resident flattened BVH + triangle geometry (jnp pytree).

    Nodes are in DFS preorder; ``node_meta[:, 0]`` = leaf first-tri slot,
    ``[:, 1]`` = leaf tri count (0 for internal), ``[:, 2]`` = skip link."""

    tri_v0: jnp.ndarray     # [T,3] leaf-ordered world-space vertices
    tri_v1: jnp.ndarray     # [T,3]
    tri_v2: jnp.ndarray     # [T,3]
    node_boxes: jnp.ndarray # [D,6] (lo xyz, hi xyz) in DFS order
    node_meta: jnp.ndarray  # [D,3] int32 (leaf_first, leaf_count, skip)


def skiplink_boxes(bvh: BVH, order: np.ndarray) -> np.ndarray:
    """Refit fast path: re-gather node boxes in a cached DFS preorder
    (the skip-link topology is invariant under refit — only box values
    move).  Vectorized; replaces the 90 ms Python DFS of build_skiplinks
    on every animated frame (BvhBLAS::refit analog, bvh.cpp:268-287)."""
    return np.concatenate(
        [bvh.node_lo[order], bvh.node_hi[order]], axis=1
    ).astype(np.float32)


def build_skiplinks(
    bvh: BVH, return_order: bool = False
) -> tuple[np.ndarray, ...]:
    """DFS-preorder node arrays with skip links (host side).

    Returns (boxes [D,6] f32, meta [D,3] i32) and, with ``return_order``,
    the node-id preorder for later ``skiplink_boxes`` refits. The
    reference's node pool (2N, node 1 unused) is compacted to the D
    reachable nodes."""
    # Iterative DFS assigning positions, left child first (matches the
    # builder's allocation order).
    n_total = bvh.nodes_used
    walk = [0]
    order = []
    while walk:
        node = walk.pop()
        order.append(node)
        if bvh.count[node] == 0:
            left = int(bvh.left_first[node])
            walk.append(left + 1)  # pushed first -> visited after left
            walk.append(left)
    d = len(order)

    # skip[i] = position after node i's whole subtree.
    size = np.zeros(n_total, np.int64)
    # compute subtree sizes bottom-up over the preorder (reverse iteration)
    for node in reversed(order):
        if bvh.count[node] != 0:
            size[node] = 1
        else:
            left = int(bvh.left_first[node])
            size[node] = 1 + size[left] + size[left + 1]

    boxes = np.empty((d, 6), np.float32)
    meta = np.empty((d, 3), np.int32)
    for i, node in enumerate(order):
        boxes[i, 0:3] = bvh.node_lo[node]
        boxes[i, 3:6] = bvh.node_hi[node]
        if bvh.count[node] != 0:
            meta[i, 0] = bvh.left_first[node]
            meta[i, 1] = bvh.count[node]
        else:
            meta[i, 0] = 0
            meta[i, 1] = 0
        meta[i, 2] = i + size[node]  # skip link
    if return_order:
        return boxes, meta, np.asarray(order, np.int64)
    return boxes, meta


class Hit(NamedTuple):
    prim: jnp.ndarray  # [N] int32 leaf-order triangle id, -1 on miss
    t: jnp.ndarray     # [N] float32
    u: jnp.ndarray     # [N] float32
    v: jnp.ndarray     # [N] float32


class WalkState(NamedTuple):
    """Per-lane automaton state of the skip-link walk."""

    dfs: jnp.ndarray       # [N] int32 next node to visit (>= END: done)
    leaf_ptr: jnp.ndarray  # [N] int32 next triangle slot of the open leaf
    leaf_end: jnp.ndarray  # [N] int32 end of the open leaf
    best_t: jnp.ndarray    # [N] f32 closest hit so far (starts at t_max)
    best_prim: jnp.ndarray # [N] int32
    best_u: jnp.ndarray    # [N] f32
    best_v: jnp.ndarray    # [N] f32


def walk_init(t_max, active, end) -> WalkState:
    """Inactive lanes start done (dfs = END, empty leaf)."""
    zi = jnp.zeros_like(t_max, dtype=jnp.int32)
    zf = jnp.zeros_like(t_max, dtype=jnp.float32)
    return WalkState(
        dfs=jnp.where(active, zi, zi + end),
        leaf_ptr=zi, leaf_end=zi,
        best_t=t_max.astype(jnp.float32),
        best_prim=zi - 1, best_u=zf, best_v=zf,
    )


def walk_done(s: WalkState, end):
    return (s.dfs >= end) & (s.leaf_ptr >= s.leaf_end)


# fetch_tri(slot) -> (v0, v1, v2) and fetch_node(node) -> (lo, hi, first,
# count, skip), with every 3-vector an (x, y, z) tuple of [N] arrays.
TriFetch = Callable[[jnp.ndarray], tuple]
NodeFetch = Callable[[jnp.ndarray], tuple]


def walk_step(s: WalkState, origin, direction, inv_dir, end, n_tris: int,
              fetch_tri: TriFetch, fetch_node: NodeFetch,
              any_hit: bool) -> WalkState:
    """One lockstep step of every lane: a triangle test for lanes inside a
    leaf, then a node visit for lanes outside one.  Done lanes are fixed
    points, so extra steps never change a lane's result.  For ``any_hit``
    a lane stops at its first hit (intersectAny's early-out,
    bvh.cpp:193-253)."""
    in_leaf = s.leaf_ptr < s.leaf_end

    # ---- LEAF step: one triangle test per lane in leaf mode --------------
    slot = jnp.clip(s.leaf_ptr, 0, n_tris - 1)
    v0, v1, v2 = fetch_tri(slot)
    hit, t, u, v = intersect_triangle_xyz(origin, direction, v0, v1, v2,
                                          s.best_t)
    upd = in_leaf & hit
    best_t = jnp.where(upd, t, s.best_t)
    best_prim = jnp.where(upd, slot, s.best_prim)
    best_u = jnp.where(upd, u, s.best_u)
    best_v = jnp.where(upd, v, s.best_v)
    leaf_ptr = jnp.where(in_leaf, s.leaf_ptr + 1, s.leaf_ptr)
    leaf_end = s.leaf_end
    if any_hit:
        leaf_ptr = jnp.where(upd, leaf_end, leaf_ptr)

    # ---- NODE step: lanes not in leaf mode visit their dfs node ----------
    trav = ~in_leaf & (s.dfs < end)
    if any_hit:
        trav = trav & (best_prim < 0)
    node = jnp.where(trav, s.dfs, jnp.zeros_like(s.dfs))
    lo, hi, first, count, skip = fetch_node(node)
    dist = intersect_aabb_xyz(origin, inv_dir, lo, hi, best_t)
    box_hit = dist < jnp.float32(1e30)
    is_leaf = count > 0

    enter_leaf = trav & box_hit & is_leaf
    leaf_ptr = jnp.where(enter_leaf, first, leaf_ptr)
    leaf_end = jnp.where(enter_leaf, first + count, leaf_end)

    new_dfs = jnp.where(
        trav, jnp.where(box_hit & ~is_leaf, s.dfs + 1, skip), s.dfs)
    if any_hit:
        new_dfs = jnp.where(best_prim >= 0, jnp.zeros_like(s.dfs) + end,
                            new_dfs)
    return WalkState(new_dfs, leaf_ptr, leaf_end, best_t, best_prim, best_u,
                     best_v)


def traverse(
    arrays: TraceArrays,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    t_max: jnp.ndarray,
    active: jnp.ndarray,
    any_hit: bool = False,
) -> Hit:
    """Closest-hit (any_hit=False) or occlusion (any_hit=True) traversal of
    all lanes in lockstep: the XLA walk.

    For any_hit the returned ``prim`` is >= 0 where occluded (first hit
    found, matching intersectAny's early-out, bvh.cpp:193-253)."""
    end = jnp.int32(arrays.node_boxes.shape[0])
    n_tris = arrays.tri_v0.shape[0]
    o, d = xyz(origin), xyz(direction)
    inv_dir = tuple(jnp.float32(1.0) / c for c in d)

    def fetch_tri(slot):
        return tuple(xyz(jnp.take(a, slot, axis=0))
                     for a in (arrays.tri_v0, arrays.tri_v1, arrays.tri_v2))

    def fetch_node(node):
        b = jnp.take(arrays.node_boxes, node, axis=0)
        m = jnp.take(arrays.node_meta, node, axis=0)
        return (b[:, 0], b[:, 1], b[:, 2]), (b[:, 3], b[:, 4], b[:, 5]), \
            m[:, 0], m[:, 1], m[:, 2]

    out = jax.lax.while_loop(
        lambda s: jnp.any(~walk_done(s, end)),
        lambda s: walk_step(s, o, d, inv_dir, end, n_tris, fetch_tri,
                            fetch_node, any_hit),
        walk_init(t_max, active, end))
    return Hit(prim=out.best_prim, t=out.best_t, u=out.best_u,
               v=out.best_v)
