"""Multi-card distribution: pixel lanes sharded over a device mesh, scene
replicated, material/camera gradients all-reduced.

The reference is single-GPU (SURVEY.md §2.3 P8 'absent'); this subsystem
*adds* distribution: a 1-D ``Mesh(('chips',))`` (or a 2-D ('hosts',
'chips') mesh across processes via jax.distributed), with

- pixel lanes (and thus every per-ray SoA array of the wavefront state)
  split over every mesh axis — pure data parallelism over the image, the
  natural decomposition for path tracing;
- the per-lane render run under ``jax.shard_map``: each card renders its
  own lanes with its own wave loop, which exits when ITS paths finish (no
  cross-card reduction per wave), and the traversal kernel, opaque to the
  SPMD partitioner, sees only local lanes;
- the compiled scene (triangles, BVH, material table) replicated, so
  traversal gathers stay card-local reads;
- gradients: each card back-propagates its own pixels' radiance into the
  *replicated* material/camera leaves; the transpose of ``shard_map``'s
  replicated inputs is a ``psum``, so the gradient all-reduce is in the
  graph and XLA's scheduler may overlap it with the backward pass.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..diff.estimator import DiffTargets, apply_targets
from ..scene.camera import CameraParams
from ..scene.compile import RenderScene
from ..wavefront.integrator import (
    RenderConfig,
    render_sample,
)
from ..scene.camera import view_plane_jnp
from ..core import rng


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D device mesh over the 'chips' axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("chips",))


def make_mesh_2d(n_hosts: int, chips_per_host: int, devices=None) -> Mesh:
    """('hosts', 'chips') 2-D mesh, hosts-major — the BASELINE config-5
    multi-host shape (dist/multihost.py builds the same mesh from
    jax.process_count() in production; this constructor also builds it
    from an explicit device list so the virtual 8-CPU test mesh can
    exercise the exact 2-D layout, e.g. 2x4)."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)[: n_hosts * chips_per_host]
    assert devices.size == n_hosts * chips_per_host, (
        f"need {n_hosts * chips_per_host} devices, have {devices.size}")
    return Mesh(devices.reshape(n_hosts, chips_per_host),
                ("hosts", "chips"))


def _lane_spec(mesh: Mesh) -> P:
    """Shard pixel lanes over EVERY mesh axis (1-D: P('chips'); 2-D:
    P(('hosts','chips')) — lanes split across hosts first, then chips,
    so cross-host traffic stays at the final image all-gather)."""
    return P(mesh.axis_names)


def _lane_arrays(cfg: RenderConfig, total_samples):
    n = cfg.width * cfg.height
    lane = jnp.arange(n, dtype=jnp.uint32)
    px = (lane % jnp.uint32(cfg.width)).astype(jnp.int32)
    py = (lane // jnp.uint32(cfg.width)).astype(jnp.int32)
    seed0 = rng.pixel_seed(lane, total_samples)
    return seed0, px, py


def _render_lanes(scene: RenderScene, cfg: RenderConfig, cam: CameraParams,
                  seed0, px, py):
    """spp-sample accumulation over (possibly sharded) lane arrays."""
    vp = view_plane_jnp(cam, cfg.width, cfg.height)

    def body(_, carry):
        seed, acc = carry
        seed, energy = render_sample(scene, cfg, vp, seed, px, py)
        return seed, acc + energy

    _, acc = jax.lax.fori_loop(
        0, cfg.spp, body, (seed0, jnp.zeros((px.shape[0], 3), jnp.float32))
    )
    return acc


def _shard_lanes(cfg: RenderConfig, mesh: Mesh):
    """``_render_lanes`` under ``shard_map``: scene and camera replicated,
    lane arrays split over every mesh axis.  ``check_vma`` is off because
    the traversal kernel's body does not track mesh-axis variance; the
    transpose still psums the cotangents of the replicated inputs."""
    lanes = _lane_spec(mesh)
    return jax.shard_map(
        lambda scene, cam, seed0, px, py: _render_lanes(
            scene, cfg, cam, seed0, px, py),
        mesh=mesh, in_specs=(P(), P(), lanes, lanes, lanes),
        out_specs=lanes, check_vma=False)


@partial(jax.jit, static_argnums=(1, 2))
def _render_sharded(scene: RenderScene, cfg: RenderConfig, mesh: Mesh, cam,
                    seed0, px, py):
    return _shard_lanes(cfg, mesh)(scene, cam, seed0, px, py)


def render_frame_sharded(scene: RenderScene, cfg: RenderConfig,
                         cam: CameraParams, total_samples, mesh: Mesh):
    """Forward frame render with pixel lanes sharded over mesh axis 'chips'.

    Returns the full [H, W, 3] radiance-sum image (replicated)."""
    n = cfg.width * cfg.height
    n_dev = mesh.devices.size
    assert n % n_dev == 0, f"lane count {n} not divisible by {n_dev} chips"

    lane_sharding = NamedSharding(mesh, _lane_spec(mesh))
    repl = NamedSharding(mesh, P())

    seed0, px, py = _lane_arrays(cfg, total_samples)
    seed0 = jax.device_put(seed0, lane_sharding)
    px = jax.device_put(px, lane_sharding)
    py = jax.device_put(py, lane_sharding)
    scene = jax.device_put(scene, repl)
    cam = jax.device_put(cam, repl)

    acc = _render_sharded(scene, cfg, mesh, cam, seed0, px, py)
    return acc.reshape(cfg.height, cfg.width, 3)


def _grad_step_args(scene: RenderScene, cfg: RenderConfig,
                    targets: DiffTargets, total_samples, mesh: Mesh,
                    reference_image=None):
    """Shared setup for grad_step_sharded / grad_step_compiled: places the
    arguments of ``_sharded_value_and_grad`` on the mesh."""
    n = cfg.width * cfg.height
    n_dev = mesh.devices.size
    assert n % n_dev == 0
    assert cfg.max_bounces is not None

    lane_sharding = NamedSharding(mesh, _lane_spec(mesh))
    repl = NamedSharding(mesh, P())

    seed0, px, py = _lane_arrays(cfg, total_samples)
    seed0 = jax.device_put(seed0, lane_sharding)
    px = jax.device_put(px, lane_sharding)
    py = jax.device_put(py, lane_sharding)
    scene = jax.device_put(scene, repl)
    targets = jax.device_put(targets, repl)
    ref = None
    if reference_image is not None:
        ref = jax.device_put(
            jnp.asarray(reference_image).reshape(n, 3), lane_sharding
        )
    return targets, scene, seed0, px, py, ref


# NOTE: every sharded lane array must be an explicit jit argument —
# closure-captured sharded arrays are treated as constants and defeat SPMD
# partitioning (observed: single-partition HLO, no all-reduce).  cfg and
# mesh are static, so repeated steps reuse one executable.
@partial(jax.jit, static_argnames=("cfg", "mesh"))
def _sharded_value_and_grad(targets, scene, seed0, px, py, ref_lanes, *,
                            cfg: RenderConfig, mesh: Mesh):
    render = _shard_lanes(cfg, mesh)

    def loss_fn(t):
        img = render(
            apply_targets(scene, t), t.camera, seed0, px, py
        ) / jnp.float32(cfg.spp)
        if ref_lanes is not None:
            d = img - ref_lanes
            return jnp.mean(d * d)
        return jnp.mean(img)

    return jax.lax.with_sharding_constraint(
        jax.value_and_grad(loss_fn)(targets), NamedSharding(mesh, P()))


def grad_step_sharded(scene: RenderScene, cfg: RenderConfig,
                      targets: DiffTargets, total_samples, mesh: Mesh,
                      reference_image=None):
    """One differentiable render + backward over the mesh: lanes sharded,
    targets replicated; the gradient all-reduce is the psum that transposes
    shard_map's replicated inputs.  Returns (loss, grads) replicated."""
    args = _grad_step_args(scene, cfg, targets, total_samples, mesh,
                           reference_image)
    return _sharded_value_and_grad(*args, cfg=cfg, mesh=mesh)


def grad_step_compiled(scene: RenderScene, cfg: RenderConfig,
                       targets: DiffTargets, total_samples, mesh: Mesh,
                       reference_image=None):
    """Compiled (but not executed) sharded grad step — lets tests assert
    on the partitioned HLO itself: lanes actually sharded over the mesh
    axes and a cross-device all-reduce present for the replicated
    material/camera gradients."""
    args = _grad_step_args(scene, cfg, targets, total_samples, mesh,
                           reference_image)
    return _sharded_value_and_grad.lower(
        *args, cfg=cfg, mesh=mesh).compile(), args


class ShardedSession:
    """Place-once / render-many wrapper (the production-shaped caller).

    ``render_frame_sharded`` re-``device_put``s the scene and lane arrays on
    every call — a host->device transfer per frame that a progressive or
    animated render should pay once.  This session places the scene and the
    static lane coordinates at construction; per-frame work is one jitted
    dispatch (plus a tiny seed upload when total_samples changes).  The
    GPUScene analog: scene SSBOs uploaded once, reused every frame
    (scene.cpp:159-258)."""

    def __init__(self, scene: RenderScene, cfg: RenderConfig, mesh: Mesh):
        n = cfg.width * cfg.height
        assert n % mesh.devices.size == 0
        self.cfg = cfg
        self.mesh = mesh
        self.lane_sharding = NamedSharding(mesh, _lane_spec(mesh))
        self.repl = NamedSharding(mesh, P())
        _, px, py = _lane_arrays(cfg, jnp.uint32(0))
        self.px = jax.device_put(px, self.lane_sharding)
        self.py = jax.device_put(py, self.lane_sharding)
        self.scene = jax.device_put(scene, self.repl)

    def update_scene(self, scene: RenderScene) -> None:
        """Re-place scene arrays (animation refresh); sharding unchanged."""
        self.scene = jax.device_put(scene, self.repl)

    def render(self, cam: CameraParams, total_samples) -> jnp.ndarray:
        """One frame; returns [H, W, 3] radiance sums (device array)."""
        cfg = self.cfg
        n = cfg.width * cfg.height
        lane = jnp.arange(n, dtype=jnp.uint32)
        seed0 = jax.device_put(
            rng.pixel_seed(lane, total_samples), self.lane_sharding)
        acc = _render_sharded(self.scene, cfg, self.mesh, cam, seed0,
                              self.px, self.py)
        return acc.reshape(cfg.height, cfg.width, 3)


def scaling_sweep(scene: RenderScene, cfg: RenderConfig, cam: CameraParams,
                  device_counts, repeats: int = 3):
    """Strong-scaling throughput vs chip count (fixed total work).  Uses
    the place-once session so per-frame timings measure render dispatch,
    not scene re-upload.  Returns {n_devices: seconds_best}.

    CAVEAT (VERDICT r3 item 5): on the virtual CPU mesh every 'device' is
    a thread pool slice of ONE machine, so fixed-total-work sweeps at
    small shapes measure dispatch overhead, not scaling — use
    weak_scaling_sweep for evidence."""
    import time

    results = {}
    for nd in device_counts:
        sess = ShardedSession(scene, cfg, make_mesh(nd))
        # warmup/compile
        img = sess.render(cam, jnp.uint32(0))
        jax.block_until_ready(img)
        best = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            img = sess.render(cam, jnp.uint32(0))
            jax.block_until_ready(img)
            best = min(best, time.perf_counter() - t0)
        results[nd] = best
    return results


def weak_scaling_sweep(make_cfg, scene: RenderScene, cam_for, device_counts,
                       repeats: int = 3):
    """Weak-scaling sweep: per-device work is held CONSTANT (the image
    grows with the device count), so per-frame time flat within noise ==
    linear scaling.  ``make_cfg(n_devices) -> RenderConfig`` must return a
    config whose lane count is proportional to n_devices (e.g. fixed
    width, height = lanes_per_device * n // width); ``cam_for(cfg)``
    builds the camera for that shape.  Returns
    {n_devices: (seconds_best, lanes_per_device)}."""
    import time

    results = {}
    for nd in device_counts:
        cfg = make_cfg(nd)
        cam = cam_for(cfg)
        sess = ShardedSession(scene, cfg, make_mesh(nd))
        img = sess.render(cam, jnp.uint32(0))
        jax.block_until_ready(img)
        best = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            img = sess.render(cam, jnp.uint32(0))
            jax.block_until_ready(img)
            best = min(best, time.perf_counter() - t0)
        results[nd] = (best, cfg.width * cfg.height // nd)
    return results
