"""BVH builder + traversal tests: native vs NumPy builders, traversal vs
brute force, refit correctness (reference: bvh.cpp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from surf_tpu.accel import builder
from surf_tpu.accel.traverse import TraceArrays, build_skiplinks, traverse
from surf_tpu.scene.mesh import make_cube, make_icosphere


def _trace_arrays(v0, v1, v2, bvh):
    boxes, meta = build_skiplinks(bvh)
    perm = bvh.indices.astype(np.int64)
    return TraceArrays(
        tri_v0=jnp.asarray(v0[perm]), tri_v1=jnp.asarray(v1[perm]),
        tri_v2=jnp.asarray(v2[perm]),
        node_boxes=jnp.asarray(boxes), node_meta=jnp.asarray(meta),
    ), perm


def _random_tris(n, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-10, 10, (n, 1, 3)).astype(np.float32)
    offs = rng.normal(0, 0.5, (n, 3, 3)).astype(np.float32)
    tris = base + offs
    return tris[:, 0], tris[:, 1], tris[:, 2]


def _validate_bvh(bvh: builder.BVH, n):
    # permutation property
    assert sorted(bvh.indices.tolist()) == list(range(n))
    # every leaf interval disjoint + covering
    seen = np.zeros(n, bool)
    stack = [0]
    while stack:
        node = stack.pop()
        if bvh.count[node] != 0:
            lo, c = int(bvh.left_first[node]), int(bvh.count[node])
            assert not seen[lo: lo + c].any()
            seen[lo: lo + c] = True
        else:
            left = int(bvh.left_first[node])
            assert left % 2 == 0 and left >= 2
            stack += [left, left + 1]
    assert seen.all()


def test_builders_agree_functionally():
    v0, v1, v2 = _random_tris(500)
    lo, hi = builder.triangle_bounds(v0, v1, v2)
    key = ((v0 + v1 + v2) * np.float32(0.333)).astype(np.float32)
    nat = builder.build_bvh(lo, hi, key)
    np_bvh = builder._numpy_build(lo, hi, key)
    _validate_bvh(nat, 500)
    _validate_bvh(np_bvh, 500)
    # same topology (stable partition preserves membership; node order and
    # bounds must match exactly)
    assert nat.nodes_used == np_bvh.nodes_used
    u = nat.nodes_used
    assert np.array_equal(nat.left_first[:u], np_bvh.left_first[:u])
    assert np.array_equal(nat.count[:u], np_bvh.count[:u])
    assert np.allclose(nat.node_lo[:u], np_bvh.node_lo[:u])
    assert np.allclose(nat.node_hi[:u], np_bvh.node_hi[:u])


@pytest.mark.parametrize("mesh_fn", [make_cube, lambda: make_icosphere(2)])
def test_traversal_matches_brute_force(mesh_fn):
    mesh = mesh_fn()
    v0, v1, v2 = mesh.v0, mesh.v1, mesh.v2
    bvh = builder.build_blas(v0, v1, v2)
    _validate_bvh(bvh, len(v0))
    arrays, perm = _trace_arrays(v0, v1, v2, bvh)

    rng = np.random.default_rng(1)
    n = 512
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    tjit = jax.jit(traverse, static_argnums=(5,))
    hit = tjit(arrays, jnp.asarray(o), jnp.asarray(d),
               jnp.full(n, 1e30, jnp.float32), jnp.ones(n, bool), False)
    prim = np.asarray(hit.prim)
    prim_orig = np.where(prim >= 0, perm[np.maximum(prim, 0)], -1)

    # brute force reference
    from surf_tpu.core.geometry import intersect_triangle
    hits, t, _, _ = jax.vmap(
        lambda oo, dd: intersect_triangle(
            oo[None], dd[None], jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(v2),
            jnp.float32(1e30),
        )
    )(jnp.asarray(o), jnp.asarray(d))
    hits = np.asarray(hits)
    t = np.where(hits, np.asarray(t), np.inf)
    bf_prim = np.where(hits.any(axis=1), t.argmin(axis=1), -1)
    bf_t = t.min(axis=1)

    assert np.array_equal(prim_orig >= 0, bf_prim >= 0)
    both = prim_orig >= 0
    assert np.allclose(np.asarray(hit.t)[both], bf_t[both], rtol=1e-5, atol=1e-6)

    # any-hit agrees on occlusion
    hit_any = tjit(arrays, jnp.asarray(o), jnp.asarray(d),
                   jnp.full(n, 1e30, jnp.float32), jnp.ones(n, bool), True)
    assert np.array_equal(np.asarray(hit_any.prim) >= 0, bf_prim >= 0)


def test_refit_tracks_moved_prims():
    v0, v1, v2 = _random_tris(200, seed=3)
    bvh = builder.build_blas(v0, v1, v2)
    shift = np.float32([5.0, 0.0, 0.0])
    v0s, v1s, v2s = v0 + shift, v1 + shift, v2 + shift
    lo, hi = builder.triangle_bounds(v0s, v1s, v2s)
    refitted = builder.refit(bvh, lo, hi)
    assert np.allclose(refitted.root_lo, bvh.root_lo + shift, atol=1e-5)
    assert np.allclose(refitted.root_hi, bvh.root_hi + shift, atol=1e-5)
    # topology untouched
    assert np.array_equal(refitted.left_first, bvh.left_first)
    assert np.array_equal(refitted.indices, bvh.indices)


def test_refit_native_matches_numpy():
    import surf_tpu.accel.native as native
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    v0, v1, v2 = _random_tris(300, seed=4)
    bvh = builder.build_blas(v0, v1, v2)
    v0s = v0 * 1.1
    lo, hi = builder.triangle_bounds(v0s, v1, v2)
    a = builder.refit(bvh, lo, hi)
    import os
    os.environ["SURF_NO_NATIVE"] = "1"
    try:
        native._LIB = None
        native._TRIED = False
        b = builder.refit(bvh, lo, hi)
    finally:
        del os.environ["SURF_NO_NATIVE"]
        native._LIB = None
        native._TRIED = False
    assert np.allclose(a.node_lo, b.node_lo)
    assert np.allclose(a.node_hi, b.node_hi)


def test_single_triangle_bvh():
    v0 = np.array([[0, 0, 0]], np.float32)
    v1 = np.array([[1, 0, 0]], np.float32)
    v2 = np.array([[0, 1, 0]], np.float32)
    bvh = builder.build_blas(v0, v1, v2)
    assert bvh.count[0] == 1  # root is a leaf
    arrays, _ = _trace_arrays(v0, v1, v2, bvh)
    o = jnp.asarray([[0.2, 0.2, -1.0], [5.0, 5.0, -1.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    hit = traverse(arrays, o, d, jnp.full(2, 1e30, jnp.float32),
                   jnp.ones(2, bool), False)
    assert int(hit.prim[0]) == 0 and int(hit.prim[1]) == -1
