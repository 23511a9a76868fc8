"""The Pallas GPU traversal kernel (accel/gpu_traverse.py) against the XLA
walk it shares its step with (accel/traverse.py) and against brute force.

On the CPU the kernel runs through the Pallas interpreter, which must
reproduce the XLA walk bit for bit (same ``walk_step``, same operation
order).  The compiled kernel needs a card: ``chip_smoke.py`` checks it
there at bench width, and the tests marked ``gpu`` skip here."""

import os
import subprocess
import sys
import warnings
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from surf_tpu.accel import gpu_traverse
from surf_tpu.accel.builder import build_blas
from surf_tpu.accel.gpu_traverse import BLOCK_RAYS, traverse_gpu
from surf_tpu.accel.select import default_platform, traversal_for
from surf_tpu.accel.traverse import TraceArrays, build_skiplinks, traverse
from surf_tpu.core import rng
from surf_tpu.core.geometry import intersect_triangle
from surf_tpu.scene import builtin
from surf_tpu.scene.camera import CameraParams, view_plane_jnp
from surf_tpu.scene.compile import HostCompiled
from surf_tpu.wavefront import RenderConfig, integrator, render_frame_jit

warnings.filterwarnings("ignore", category=RuntimeWarning)

REPO = Path(__file__).resolve().parents[1]
kernel = partial(traverse_gpu, interpret=True)
xla_walk = jax.jit(traverse, static_argnums=(5,))


@pytest.fixture(scope="module")
def scenes():
    return {"box": HostCompiled(builtin.make_diffuse_box_scene()),
            "indoor": HostCompiled(builtin.make_indoor_scene())}


@pytest.fixture
def route(monkeypatch):
    """route(fn) sends the integrator's traversals to ``fn`` — the
    interpreted kernel stands for what a GPU runs compiled.  Jit caches are
    dropped at each switch so no executable traced for the other path is
    reused."""
    def use(fn):
        jax.clear_caches()
        monkeypatch.setattr(integrator, "traversal_for", lambda platform: fn)

    yield use
    jax.clear_caches()


def _rays(n, seed, span):
    gen = np.random.default_rng(seed)
    o = gen.uniform(-span, span, (n, 3)).astype(np.float32)
    d = gen.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _assert_identical(a, b):
    for name in ("prim", "t", "u", "v"):
        assert np.array_equal(np.asarray(getattr(a, name)),
                              np.asarray(getattr(b, name))), name


def _brute_force(v0, v1, v2, o, d, t_max):
    """(prim, t) of the closest hit over every triangle, -1 / inf on miss."""
    hit, t, _, _ = intersect_triangle(
        o[:, None, :], d[:, None, :], v0[None], v1[None], v2[None],
        t_max[:, None])
    t = np.where(np.asarray(hit), np.asarray(t), np.inf)
    prim = np.where(np.isfinite(t).any(axis=1), t.argmin(axis=1), -1)
    return prim, t.min(axis=1)


@pytest.mark.parametrize("lanes", ["all_active", "half_inactive", "ragged"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("scene", ["box", "indoor"])
def test_kernel_matches_xla_walk(scenes, scene, any_hit, lanes):
    """Bit-identical Hit on every lane, with inactive lanes and a ray count
    that is not a multiple of the block (the wrapper pads)."""
    trace = scenes[scene].render_scene.trace
    n = 1000 if lanes == "ragged" else 1024
    o, d = _rays(n, seed=3, span=3.0 if scene == "indoor" else 6.0)
    t_max = jnp.full(n, 1e30, jnp.float32)
    active = jnp.ones(n, bool)
    if lanes == "half_inactive":
        active = jnp.asarray(np.random.default_rng(4).random(n) < 0.5)
    a = xla_walk(trace, o, d, t_max, active, any_hit)
    b = kernel(trace, o, d, t_max, active, any_hit)
    _assert_identical(a, b)
    assert (np.asarray(b.prim) >= 0).any()
    assert (np.asarray(b.prim)[~np.asarray(active)] == -1).all()


def _soup_trace(n_tris, seed):
    gen = np.random.default_rng(seed)
    base = gen.uniform(-5, 5, (n_tris, 1, 3)).astype(np.float32)
    if seed == 4:
        base[: n_tris // 2] = base[0]  # clustered centroids -> fat SAH leaf
    tris = base + gen.normal(0, 0.4, (n_tris, 3, 3)).astype(np.float32)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    bvh = build_blas(v0, v1, v2, min_leaf=4, max_leaf=8)
    boxes, meta = build_skiplinks(bvh)
    perm = bvh.indices.astype(np.int64)
    trace = TraceArrays(jnp.asarray(v0[perm]), jnp.asarray(v1[perm]),
                        jnp.asarray(v2[perm]), jnp.asarray(boxes),
                        jnp.asarray(meta))
    return trace, gen


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("n_tris,seed", [(1, 0), (8, 1), (9, 2), (64, 3),
                                          (500, 4)])
def test_random_soups_vs_brute_force(n_tris, seed, any_hit):
    """Random triangle soups, including sizes around the 8-triangle leaf
    bound and clustered centroids (which exercise enforce_max_leaf)."""
    trace, gen = _soup_trace(n_tris, seed)
    n = 256
    o = gen.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = gen.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.full(n, 1e30, np.float32)
    h = kernel(trace, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
               jnp.ones(n, bool), any_hit)
    bf_prim, bf_t = _brute_force(trace.tri_v0, trace.tri_v1, trace.tri_v2,
                                 o, d, t_max)
    prim = np.asarray(h.prim)
    assert np.array_equal(prim >= 0, bf_prim >= 0)
    if not any_hit:
        has = bf_prim >= 0
        assert np.allclose(np.asarray(h.t)[has], bf_t[has], rtol=1e-5)
        tie = np.asarray(h.t) == bf_t
        assert ((prim == bf_prim) | tie | ~has).all()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
def test_kernel_after_animation_refit(any_hit):
    """After an animated frame refits the BVH (new boxes, same topology),
    the kernel still equals the XLA walk and sees the moved geometry."""
    host = HostCompiled(builtin.make_indoor_scene())
    before = host.render_scene.trace
    host.update(0.5)
    trace = host.render_scene.trace
    assert not np.array_equal(np.asarray(before.node_boxes),
                              np.asarray(trace.node_boxes))
    n = 512
    o, d = _rays(n, seed=9, span=3.0)
    t_max = jnp.full(n, 1e30, jnp.float32)
    active = jnp.ones(n, bool)
    h = kernel(trace, o, d, t_max, active, any_hit)
    _assert_identical(xla_walk(trace, o, d, t_max, active, any_hit), h)
    bf_prim, _ = _brute_force(trace.tri_v0, trace.tri_v1, trace.tri_v2,
                              np.asarray(o), np.asarray(d),
                              np.asarray(t_max))
    assert np.array_equal(np.asarray(h.prim) >= 0, bf_prim >= 0)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("family", ["axis_aligned", "zero_component"])
def test_degenerate_directions(scenes, family, any_hit):
    """Directions with zero components give infinite inverse components and
    NaN slab products on slab planes; the kernel must resolve them exactly
    as the XLA walk does (C-ternary min/max)."""
    trace = scenes["box"].render_scene.trace
    if family == "axis_aligned":
        dirs = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    else:
        s = np.float32(np.sqrt(0.5))
        dirs = np.asarray([[s, s, 0], [0, s, -s], [-s, 0, s],
                           [s, -s, 0], [0, -s, -s], [-s, 0, -s]], np.float32)
    gen = np.random.default_rng(5)
    o = gen.uniform(-4, 4, (128, 3)).astype(np.float32)
    o[:16] = np.round(o[:16])  # origins on slab planes of the box walls
    o = np.repeat(o, len(dirs), axis=0)
    d = np.tile(dirs, (128, 1))
    n = len(o)
    t_max = jnp.full(n, 1e30, jnp.float32)
    active = jnp.ones(n, bool)
    a = xla_walk(trace, jnp.asarray(o), jnp.asarray(d), t_max, active, any_hit)
    b = kernel(trace, jnp.asarray(o), jnp.asarray(d), t_max, active, any_hit)
    _assert_identical(a, b)
    assert (np.asarray(b.prim) >= 0).any()


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
def test_tight_t_max(scenes, any_hit):
    """t_max bounds the hit strictly (depthInBounds: t < t_max): a bound at
    the closest hit's own t hides it, a bound 1% past it keeps it."""
    trace = scenes["indoor"].render_scene.trace
    n = 512
    o, d = _rays(n, seed=11, span=3.0)
    far = jnp.full(n, 1e30, jnp.float32)
    active = jnp.ones(n, bool)
    ref = xla_walk(trace, o, d, far, active, False)
    hit = np.asarray(ref.prim) >= 0
    t_hit = np.where(hit, np.asarray(ref.t), 1e30).astype(np.float32)
    at = jnp.asarray(t_hit)
    past = jnp.asarray(t_hit * np.float32(1.01))
    h_at = kernel(trace, o, d, at, active, any_hit)
    h_past = kernel(trace, o, d, past, active, any_hit)
    _assert_identical(xla_walk(trace, o, d, at, active, any_hit), h_at)
    _assert_identical(xla_walk(trace, o, d, past, active, any_hit), h_past)
    assert (np.asarray(h_past.prim) >= 0)[hit].all()
    # (<=, not <: XLA may recompute t with another FMA contraction for
    # the store than for the bound test)
    found = np.asarray(h_at.prim) >= 0
    assert (np.asarray(h_at.t) <= t_hit)[found].all()
    if not any_hit:
        assert np.array_equal(np.asarray(h_past.prim)[hit],
                              np.asarray(ref.prim)[hit])


@pytest.mark.parametrize("n", [1, BLOCK_RAYS - 1, BLOCK_RAYS, BLOCK_RAYS + 1,
                               3 * BLOCK_RAYS + 7])
def test_wrapper_shapes_and_padding(scenes, n):
    """Any ray count: the wrapper pads to whole blocks with inactive lanes
    and returns exactly n lanes of the Hit dtypes."""
    trace = scenes["box"].render_scene.trace
    o, d = _rays(n, seed=n, span=6.0)
    t_max = jnp.full(n, 1e30, jnp.float32)
    active = jnp.ones(n, bool)
    h = kernel(trace, o, d, t_max, active, False)
    assert h.prim.shape == h.t.shape == h.u.shape == h.v.shape == (n,)
    assert h.prim.dtype == jnp.int32 and h.t.dtype == jnp.float32
    _assert_identical(xla_walk(trace, o, d, t_max, active, False), h)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
def test_kernel_lowers_for_cuda(scenes, any_hit):
    """The kernel lowers through Pallas's Triton route for CUDA here, with
    no card: every primitive of the walk has a Triton lowering, and the
    call is a Triton custom call named after the kernel."""
    trace = scenes["box"].render_scene.trace
    n = 4 * BLOCK_RAYS
    o, d = _rays(n, seed=1, span=6.0)
    exported = jax.export.export(
        jax.jit(partial(traverse_gpu, any_hit=any_hit)),
        platforms=["cuda"],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")],
    )(trace, o, d, jnp.full(n, 1e30, jnp.float32), jnp.ones(n, bool))
    text = exported.mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    name = "bvh_traverse_anyhit" if any_hit else "bvh_traverse_closest"
    assert name in text
    assert f"grid_x = {n // BLOCK_RAYS}" in text


@pytest.mark.parametrize("config", ["plain", "compact_ladder_morton"])
def test_box_render_through_kernel_path(scenes, route, config):
    """A 16x16 render whose every traversal runs the kernel: primary-ray
    prims identical on every lane, and the image equal to the XLA-walk
    render (the same per-lane arithmetic)."""
    host = scenes["box"]
    W = H = 16
    cam = builtin.make_indoor_camera(W, H)
    cp = CameraParams.from_camera(cam)
    cfg = RenderConfig.for_scene(host.static, W, H, 2, use_defocus=True)
    if config != "plain":
        cfg = cfg._replace(max_bounces=None, wave_limit=16, compact=True,
                           compact_every=2, ladder=2, ladder_shrink=2,
                           pixel_order="morton")
    route(kernel)
    img_k = np.asarray(render_frame_jit(host.render_scene, cfg, cp,
                                        jnp.uint32(0)))

    vp = view_plane_jnp(cp, W, H)
    lane = jnp.arange(W * H, dtype=jnp.uint32)
    seed = rng.pixel_seed(lane, jnp.uint32(0))
    _, o, d = integrator.ray_generation(
        cfg, vp, seed, (lane % W).astype(jnp.int32),
        (lane // W).astype(jnp.int32))
    far = jnp.full(W * H, 1e30, jnp.float32)
    act = jnp.ones(W * H, bool)
    h_k = kernel(host.render_scene.trace, o, d, far, act, False)

    route(traverse)
    img_x = np.asarray(render_frame_jit(host.render_scene, cfg, cp,
                                        jnp.uint32(0)))
    h_x = xla_walk(host.render_scene.trace, o, d, far, act, False)
    assert np.array_equal(np.asarray(h_k.prim), np.asarray(h_x.prim))
    assert np.isfinite(img_k).all() and img_k.sum() > 0
    assert np.abs(img_k - img_x).max() <= 1e-6 * np.abs(img_x).max()


def test_grad_through_kernel_path(scenes, route):
    """jax.grad through a render whose traversals run the kernel equals the
    gradient through the XLA walk (the traversal is detached; the chosen
    triangle is re-intersected differentiably either way)."""
    from surf_tpu.diff import DiffTargets, grad_image_loss

    host = scenes["box"]
    W = H = 8
    cam = builtin.make_indoor_camera(W, H)
    cfg = RenderConfig.for_scene(host.static, W, H, 1,
                                 use_defocus=True)._replace(max_bounces=4)
    targets = DiffTargets.from_scene(host.render_scene,
                                     CameraParams.from_camera(cam))
    route(kernel)
    loss_k, g_k = grad_image_loss(host.render_scene, cfg, targets,
                                  jnp.uint32(0))
    route(traverse)
    loss_x, g_x = grad_image_loss(host.render_scene, cfg, targets,
                                  jnp.uint32(0))
    assert float(loss_k) == float(loss_x)
    for a, b in zip(jax.tree.leaves(g_k), jax.tree.leaves(g_x)):
        assert np.isfinite(np.asarray(a)).all()
        assert np.allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                           atol=1e-9)
    assert float(jnp.abs(g_k.albedo).sum()) > 0


@pytest.mark.parametrize("platform,expected", [
    ("gpu", traverse_gpu), ("cpu", traverse), ("rocm", None), ("metal", None)])
def test_platform_selector(platform, expected):
    """One function maps a platform to its traversal; anything without one
    is an error, never a silent fallback."""
    if expected is None:
        with pytest.raises(ValueError, match=platform):
            traversal_for(platform)
    else:
        assert traversal_for(platform) is expected


def test_default_platform_follows_default_device():
    assert default_platform() == "cpu"  # conftest pins the CPU backend
    with jax.default_device(jax.devices("cpu")[1]):
        assert default_platform() == "cpu"
    with jax.default_device("cpu"):
        assert default_platform() == "cpu"


@pytest.mark.parametrize("env", ["set", "unset"])
def test_compile_cache_helper(monkeypatch, tmp_path, env):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without it
    the cache goes to the checkout's fixed .jax_cache directory."""
    from surf_tpu.utils import platform

    old = jax.config.jax_compilation_cache_dir
    try:
        if env == "set":
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert platform.use_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == old
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = platform.use_compile_cache()
            assert got == str(REPO / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_entry_points_fail_without_gpu(script):
    """No GPU: exit non-zero, print no result line, never fall back."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(REPO / script)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"value"' not in out.stdout
    assert "no GPU" in out.stderr


def test_sharded_render_keeps_traversal_in_shard_map(scenes, route):
    """The sharded render runs the traversal inside a shard_map whose lanes
    are split over the mesh: the kernel sees only its card's lanes."""
    from surf_tpu.dist import make_mesh
    from surf_tpu.dist import sharding as sh

    host = scenes["box"]
    W = H = 32  # 128 lanes per card: two kernel blocks, no padding
    cfg = RenderConfig.for_scene(host.static, W, H, 1,
                                 use_defocus=True)._replace(max_bounces=2)
    cam = CameraParams.from_camera(builtin.make_indoor_camera(W, H))
    mesh = make_mesh(8)
    route(kernel)
    seed0, px, py = sh._lane_arrays(cfg, jnp.uint32(0))
    jaxpr = jax.make_jaxpr(sh._shard_lanes(cfg, mesh))(
        host.render_scene, cam, seed0, px, py)
    [smap] = [e for e in jaxpr.eqns if e.primitive.name == "shard_map"]
    calls = []

    def walk(jx):
        for e in jx.eqns:
            if e.primitive.name == "pallas_call":
                calls.append(e)
            for v in e.params.values():
                for sub in v if isinstance(v, (tuple, list)) else [v]:
                    if isinstance(sub, jax.extend.core.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jax.extend.core.Jaxpr):
                        walk(sub)

    walk(smap.params["jaxpr"])
    assert calls, "no traversal kernel inside the shard_map"
    local = W * H // 8
    for e in calls:
        assert all(v.aval.shape == (local,) for v in e.outvars)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_walk_on_gpu(scenes):
    """The compiled kernel on a card against the XLA walk on the CPU
    device of the same process (chip_smoke.py phase 2 at bench width)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")
    trace = scenes["indoor"].render_scene.trace
    n = 4096
    o, d = _rays(n, seed=2, span=3.0)
    t_max = jnp.full(n, 1e30, jnp.float32)
    active = jnp.ones(n, bool)
    on_gpu = jax.device_put((trace, o, d, t_max, active), gpus[0])
    h = gpu_traverse.traverse_gpu(*on_gpu)
    ref = xla_walk(trace, o, d, t_max, active, False)
    assert (np.asarray(h.prim) == np.asarray(ref.prim)).mean() >= 0.9999
