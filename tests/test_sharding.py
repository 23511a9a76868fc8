"""Multi-chip sharding tests on the 8-virtual-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8; SURVEY.md §4)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from surf_tpu.diff import DiffTargets, grad_image_loss
from surf_tpu.dist import grad_step_sharded, make_mesh, render_frame_sharded
from surf_tpu.scene import builtin
from surf_tpu.scene.camera import CameraParams
from surf_tpu.scene.compile import HostCompiled
from surf_tpu.wavefront import RenderConfig, render_frame_jit

warnings.filterwarnings("ignore", category=RuntimeWarning)


@pytest.fixture(scope="module")
def setup():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    host = HostCompiled(builtin.make_diffuse_box_scene())
    W = H = 16
    cam = builtin.make_indoor_camera(W, H)
    cfg = RenderConfig.for_scene(host.static, W, H, 2, use_defocus=True)
    return host, cam, cfg


def test_sharded_matches_single_device(setup):
    """Same seed => sharded render must equal the single-device render
    bit-for-bit (lane computation is embarrassingly parallel)."""
    host, cam, cfg = setup
    cp = CameraParams.from_camera(cam)
    single = np.asarray(
        render_frame_jit(host.render_scene, cfg, cp, jnp.uint32(0))
    )
    for nd in (2, 8):
        mesh = make_mesh(nd)
        sharded = np.asarray(
            render_frame_sharded(host.render_scene, cfg, cp, jnp.uint32(0), mesh)
        )
        assert np.allclose(single, sharded, atol=1e-5), nd


def test_sharded_gradients_match_single_device(setup):
    """The SPMD-derived gradient all-reduce must reproduce single-device
    gradients for materials and camera."""
    host, cam, cfg = setup
    cfg = cfg._replace(max_bounces=12)
    targets = DiffTargets.from_scene(
        host.render_scene, CameraParams.from_camera(cam)
    )
    loss1, g1 = grad_image_loss(host.render_scene, cfg, targets, jnp.uint32(0))
    mesh = make_mesh(8)
    loss8, g8 = grad_step_sharded(
        host.render_scene, cfg, targets, jnp.uint32(0), mesh
    )
    assert np.isclose(float(loss1), float(loss8), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g8)):
        assert np.allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_gradient_allreduce_in_compiled_graph(setup):
    """The backward pass over sharded lanes into replicated targets must
    contain a cross-chip reduction (the material-gradient all-reduce)."""
    host, cam, cfg = setup
    cfg = cfg._replace(max_bounces=4)
    targets = DiffTargets.from_scene(
        host.render_scene, CameraParams.from_camera(cam)
    )
    mesh = make_mesh(8)

    # Reuse grad_step_sharded's internals via lowering: compile and inspect.
    import surf_tpu.dist.sharding as sh
    from jax.sharding import NamedSharding, PartitionSpec as P

    lane_sharding = NamedSharding(mesh, P("chips"))
    repl = NamedSharding(mesh, P())
    seed0, px, py = sh._lane_arrays(cfg, jnp.uint32(0))
    seed0 = jax.device_put(seed0, lane_sharding)
    px = jax.device_put(px, lane_sharding)
    py = jax.device_put(py, lane_sharding)
    scene = jax.device_put(host.render_scene, repl)
    t_repl = jax.device_put(targets, repl)

    def loss_fn(t, sc, seed0, px, py):
        img = sh._render_lanes(
            sh.apply_targets(sc, t), cfg, t.camera, seed0, px, py
        )
        return jnp.mean(img)

    lowered = jax.jit(
        jax.grad(loss_fn), out_shardings=repl
    ).lower(t_repl, scene, seed0, px, py)
    compiled_text = lowered.compile().as_text()
    assert "num_partitions=8" in compiled_text
    assert "all-reduce" in compiled_text, "expected a gradient all-reduce"


def test_grad_step_compiled_partitions_2d_mesh(setup):
    """grad_step_sharded's own compiled HLO on the ('hosts','chips') mesh
    (VERDICT r3 item 5): the program is 8-way SPMD-partitioned, the lane
    arrays are sharded over BOTH mesh axes, and a cross-device all-reduce
    exists for the replicated material/camera gradients."""
    from jax.sharding import PartitionSpec as P

    from surf_tpu.dist import grad_step_compiled, make_mesh_2d

    host, cam, cfg = setup
    cfg = cfg._replace(max_bounces=4)
    targets = DiffTargets.from_scene(
        host.render_scene, CameraParams.from_camera(cam)
    )
    compiled, args = grad_step_compiled(
        host.render_scene, cfg, targets, jnp.uint32(0), make_mesh_2d(2, 4)
    )
    text = compiled.as_text()
    assert "num_partitions=8" in text, "program not SPMD-partitioned"
    assert "all-reduce" in text, "expected a gradient all-reduce"
    seed0, px, py = args[2], args[3], args[4]
    for lane_arr in (seed0, px, py):
        assert lane_arr.sharding.spec == P(("hosts", "chips"))
        # actually partitioned: each device holds 1/8 of the lanes
        shard = next(iter(lane_arr.addressable_shards))
        assert shard.data.shape[0] == lane_arr.shape[0] // 8


def test_kernel_interpret_composes_with_mesh(setup, monkeypatch):
    """The GPU device path (the Pallas traversal kernel, in interpret mode
    on the CPU) must compile AND execute inside the 8-device sharded
    render's shard_map, and give the XLA walk's image: the kernel runs the
    same walk step, so the per-lane arithmetic is the same."""
    from functools import partial

    from surf_tpu.accel.gpu_traverse import traverse_gpu
    from surf_tpu.wavefront import integrator

    host, cam, cfg = setup
    cp = CameraParams.from_camera(cam)
    base = cfg._replace(max_bounces=None, wave_limit=6, compact=True)
    mesh = make_mesh(8)
    ref = np.asarray(
        render_frame_sharded(host.render_scene, base, cp, jnp.uint32(0),
                             mesh))
    jax.clear_caches()
    monkeypatch.setattr(integrator, "traversal_for",
                        lambda platform: partial(traverse_gpu,
                                                 interpret=True))
    try:
        img = np.asarray(
            render_frame_sharded(host.render_scene, base, cp, jnp.uint32(0),
                                 mesh))
    finally:
        jax.clear_caches()
    assert np.isfinite(img).all() and img.sum() > 0
    assert np.abs(img - ref).max() <= 1e-6 * np.abs(ref).max()


def test_2d_host_chip_mesh_matches_single_device(setup):
    """BASELINE config 5's ('hosts','chips') 2-D mesh (2x4 on the virtual
    8-CPU backend): render must be bit-identical to single-device and to
    the 1-D mesh — the multi-host layout is the same SPMD program."""
    from surf_tpu.dist import make_mesh_2d

    host, cam, cfg = setup
    cp = CameraParams.from_camera(cam)
    single = np.asarray(
        render_frame_jit(host.render_scene, cfg, cp, jnp.uint32(0))
    )
    mesh2d = make_mesh_2d(2, 4)
    assert mesh2d.axis_names == ("hosts", "chips")
    sharded = np.asarray(
        render_frame_sharded(host.render_scene, cfg, cp, jnp.uint32(0),
                             mesh2d)
    )
    assert np.allclose(single, sharded, atol=1e-5)


def test_2d_mesh_gradients_match_1d(setup):
    """Gradient all-reduce over the 2-D mesh == 1-D mesh == single device."""
    from surf_tpu.dist import make_mesh_2d

    host, cam, cfg = setup
    cfg = cfg._replace(max_bounces=8)
    targets = DiffTargets.from_scene(
        host.render_scene, CameraParams.from_camera(cam)
    )
    loss1, g1 = grad_step_sharded(
        host.render_scene, cfg, targets, jnp.uint32(0), make_mesh(8)
    )
    loss2, g2 = grad_step_sharded(
        host.render_scene, cfg, targets, jnp.uint32(0), make_mesh_2d(2, 4)
    )
    assert np.isclose(float(loss1), float(loss2), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        assert np.allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                           atol=1e-6)


def test_sharded_session_place_once(setup):
    """ShardedSession (place-once) must reproduce render_frame_sharded and
    not re-upload the scene between frames."""
    from surf_tpu.dist import ShardedSession

    host, cam, cfg = setup
    cp = CameraParams.from_camera(cam)
    mesh = make_mesh(8)
    sess = ShardedSession(host.render_scene, cfg, mesh)
    a = np.asarray(sess.render(cp, jnp.uint32(0)))
    b = np.asarray(
        render_frame_sharded(host.render_scene, cfg, cp, jnp.uint32(0), mesh)
    )
    assert np.array_equal(a, b)
    # second frame continues the accumulator stream (different seeds)
    c = np.asarray(sess.render(cp, jnp.uint32(cfg.spp)))
    assert not np.array_equal(a, c)


def test_allreduce_count_independent_of_lane_count(setup):
    """Scaling the image (lane count) must not change the NUMBER of
    cross-chip collectives in the compiled train step — gradient
    all-reduces are per-target-tensor, not per-lane-shard (VERDICT r4
    item 7: pin the collective structure the weak-scaling gate relies
    on).  A sharding regression that inserted per-lane-chunk collectives
    (e.g. resharding inside the wave loop) would show up as a count that
    grows with width."""
    from surf_tpu.dist import grad_step_compiled, make_mesh_2d

    host, cam, _ = setup
    counts = {}
    for W in (16, 32):
        cfg = RenderConfig.for_scene(
            host.static, W, 16, 1, use_defocus=True
        )._replace(max_bounces=4)
        targets = DiffTargets.from_scene(
            host.render_scene,
            CameraParams.from_camera(builtin.make_indoor_camera(W, 16)),
        )
        compiled, _ = grad_step_compiled(
            host.render_scene, cfg, targets, jnp.uint32(0), make_mesh_2d(2, 4)
        )
        text = compiled.as_text()
        counts[W] = text.count("all-reduce-start") or text.count("all-reduce(")
        assert counts[W] > 0, "expected at least one gradient all-reduce"
    assert counts[16] == counts[32], counts


def test_grad_step_sharded_reuses_its_executable(setup):
    """Repeated gradient steps (an optimizer loop) must not re-trace and
    re-compile: cfg and mesh are static arguments of one jitted step."""
    import surf_tpu.dist.sharding as sh

    host, cam, cfg = setup
    cfg = cfg._replace(max_bounces=2, spp=1)
    targets = DiffTargets.from_scene(
        host.render_scene, CameraParams.from_camera(cam))
    mesh = make_mesh(8)
    before = sh._sharded_value_and_grad._cache_size()
    for step in range(3):
        loss, _ = grad_step_sharded(
            host.render_scene, cfg, targets, jnp.uint32(step), mesh)
        assert np.isfinite(float(loss))
    assert sh._sharded_value_and_grad._cache_size() == before + 1


def test_uneven_lane_count_rejected(setup):
    host, cam, cfg = setup
    bad_cfg = cfg._replace(width=15, height=3)  # 45 lanes, not divisible by 8
    with pytest.raises(AssertionError):
        render_frame_sharded(
            host.render_scene, bad_cfg, CameraParams.from_camera(cam),
            jnp.uint32(0), make_mesh(8),
        )
