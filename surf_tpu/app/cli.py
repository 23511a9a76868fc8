"""CLI driver — the headless analog of the reference's main loop
(/root/reference/sources/main.cpp:381-446): progressive frames with optional
animation, per-frame metrics, accumulator checkpoint/resume, image output.

    python -m surf_tpu.app.cli --scene indoor --width 512 --height 512 \
        --spp 4 --frames 4 --output out.png --metrics-jsonl metrics.jsonl
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..utils.platform import use_compile_cache
from .config import AppConfig
from .image_io import save_image
from .metrics import MetricsLog


def build_scene(cfg: AppConfig):
    """Returns (HostCompiled, camera_spec|None)."""
    from ..scene import builtin
    from ..scene.compile import HostCompiled

    cam_spec = None
    if cfg.scene == "indoor":
        scene = builtin.make_indoor_scene()
    elif cfg.scene == "box":
        scene = builtin.make_diffuse_box_scene()
    elif cfg.scene.endswith(".json"):
        from ..scene.loader import load_scene_file

        scene, cam_spec = load_scene_file(cfg.scene)
    else:
        raise ValueError(f"unknown scene: {cfg.scene}")
    return HostCompiled(scene), cam_spec


def run(cfg: AppConfig) -> dict:
    if cfg.backend == "cpu":
        from ..utils import force_cpu

        force_cpu()
    elif cfg.backend == "cpu8":
        from ..utils import force_cpu

        force_cpu(8)

    import jax
    import jax.numpy as jnp

    from ..scene.builtin import make_indoor_camera
    from ..scene.camera import CameraParams
    from ..wavefront.accumulator import Accumulator
    from ..wavefront.integrator import RenderConfig, render_frame_jit

    host, cam_spec = build_scene(cfg)
    if cam_spec is not None:
        from ..scene.loader import camera_from_spec

        cam = camera_from_spec(cam_spec, cfg.width, cfg.height)
    else:
        cam = make_indoor_camera(cfg.width, cfg.height)
    if cfg.focal_length is not None:
        cam.focal_length = cfg.focal_length
    if cfg.defocus_angle is not None:
        cam.defocus_angle = cfg.defocus_angle
    cam_params = CameraParams.from_camera(cam)

    rcfg = RenderConfig.for_scene(
        host.static, cfg.width, cfg.height, cfg.spp,
        use_defocus=cam.defocus_angle != 0.0,
        max_bounces=cfg.max_bounces,
    )._replace(compact=cfg.compact)
    if cfg.wave_limit is not None:
        rcfg = rcfg._replace(wave_limit=cfg.wave_limit)
    if cfg.ladder:
        rcfg = rcfg._replace(ladder=cfg.ladder,
                             ladder_shrink=cfg.ladder_shrink)
    # pixel_order applies to the plain render path; the sharded /
    # wave-stats / deferral variants keep their own native lane layouts.
    if not (cfg.shard or cfg.wave_stats or cfg.defer):
        rcfg = rcfg._replace(pixel_order=cfg.pixel_order)

    if cfg.resume and cfg.checkpoint:
        acc = Accumulator.load(cfg.checkpoint)
        assert acc.width == cfg.width and acc.height == cfg.height
    else:
        acc = Accumulator(cfg.width, cfg.height)
    acc.total_samples += cfg.seed_offset

    mesh = None
    if cfg.shard:
        from ..dist import make_mesh

        mesh = make_mesh()

    log = MetricsLog(cfg.width, cfg.height, cfg.metrics_jsonl)
    print(
        f"surf_tpu: {cfg.scene} {cfg.width}x{cfg.height} spp={cfg.spp} "
        f"frames={cfg.frames} tris={host.static.tri_count} "
        f"devices={len(jax.devices())}{' (sharded)' if mesh else ''}"
    )

    # Frames in flight (renderer.h:22, FRAMES_IN_FLIGHT=3): device dispatch
    # of frame N+1 overlaps the host readback/accumulation of frame N.  JAX
    # dispatch is async, so "in flight" just means deferring
    # block_until_ready by up to (depth-1) frames; the XLA runtime queues
    # the device work.  depth=1 reproduces the strictly-blocking loop.
    import collections

    flight = max(1, cfg.frames_in_flight)
    pending: collections.deque = collections.deque()

    def finish_one():
        radiance_d, spp_f, extra_f, clear_first = pending.popleft()
        if clear_first:
            # Scene motion invalidates the accumulator (main.cpp:411-419);
            # deferred to drain time so in-flight frames land in order.
            acc.clear()
        # Stats stay device arrays until drain time so --wave-stats does
        # not serialize the dispatch loop under --frames-in-flight.
        extra_f = {k: float(np.asarray(v)) for k, v in extra_f.items()}
        radiance_h = np.asarray(jax.block_until_ready(radiance_d))
        acc.add_frame(radiance_h, spp_f)
        m = log.tick(spp_f, acc.total_samples, acc.energy(), **extra_f)
        print(m.format_line())
        if extra_f:
            print(f"  waves={extra_f['waves']:.0f} "
                  f"occupancy={extra_f['occupancy']:.3f} "
                  f"deferred={extra_f['deferred']:.0f}")

    carry = None
    dispatch_samples = acc.total_samples
    for frame in range(cfg.frames):
        clear_first = False
        if cfg.animate and frame > 0:
            host.update(cfg.dt, rebuild=cfg.rebuild_bvh)
            clear_first = True
            dispatch_samples = 0

        extra = {}
        if mesh is not None:
            from ..dist import render_frame_sharded

            radiance = render_frame_sharded(
                host.render_scene, rcfg, cam_params,
                jnp.uint32(dispatch_samples), mesh,
            )
        elif cfg.wave_stats:
            from ..wavefront.integrator import render_frame_instrumented

            radiance, extra = render_frame_instrumented(
                host.render_scene, rcfg, cam_params,
                jnp.uint32(dispatch_samples),
            )
        elif cfg.defer:
            # Cross-frame deferral (renderer.cpp:1101-1104): capped-out
            # paths resume next frame; zero estimator bias at any wave cap.
            from ..wavefront.integrator import (
                empty_frame_carry,
                initial_seeds,
                render_frame_carry_jit,
            )

            if frame == 0 or carry is None:
                carry = empty_frame_carry(rcfg)
            if cfg.animate and frame > 0:
                carry = empty_frame_carry(rcfg)  # scene moved: discard
            seed0 = initial_seeds(rcfg, jnp.uint32(dispatch_samples))
            radiance, _, carry = render_frame_carry_jit(
                host.render_scene, rcfg, cam_params, seed0, carry,
            )
        else:
            radiance = render_frame_jit(
                host.render_scene, rcfg, cam_params,
                jnp.uint32(dispatch_samples),
            )
        pending.append((radiance, cfg.spp, extra, clear_first))
        dispatch_samples += cfg.spp
        while len(pending) >= flight:
            finish_one()
    while pending:
        finish_one()

    if cfg.checkpoint and not cfg.resume:
        acc.save(cfg.checkpoint)
    if cfg.output:
        save_image(cfg.output, acc.resolve())
        print(f"wrote {cfg.output}")

    return {
        "energy": acc.energy(),
        "total_samples": acc.total_samples,
        "mrays_per_s": log.history[-1].mrays_per_s if log.history else 0.0,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="surf_tpu", description=__doc__)
    p.add_argument("--config", help="JSON config file (AppConfig fields)")
    p.add_argument("--scene", default="indoor",
                   help="indoor | box | path to a scene .json")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--max-bounces", type=int, default=None)
    p.add_argument("--animate", action="store_true")
    p.add_argument("--rebuild-bvh", action="store_true")
    p.add_argument("--focal-length", type=float, default=None)
    p.add_argument("--defocus-angle", type=float, default=None)
    p.add_argument("--backend", default="default",
                   choices=["default", "cpu", "cpu8"])
    p.add_argument("--shard", action="store_true")
    p.add_argument("--output", default=None)
    p.add_argument("--metrics-jsonl", default=None)
    p.add_argument("--wave-stats", action="store_true")
    p.add_argument("--compact", action="store_true")
    p.add_argument("--defer", action="store_true", dest="defer_paths")
    p.add_argument("--wave-limit", type=int, default=None)
    p.add_argument("--ladder", type=int, default=0,
                   help="width-ladder rungs for the wave loop")
    p.add_argument("--ladder-shrink", type=int, default=4,
                   help="ladder width divisor per rung")
    p.add_argument("--pixel-order", default="native",
                   choices=["native", "morton"],
                   help="lane->pixel mapping (morton = tiled packets)")
    p.add_argument("--frames-in-flight", type=int, default=1,
                   help="dispatch-ahead depth (reference FRAMES_IN_FLIGHT=3)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", action="store_true")
    args = p.parse_args(argv)
    use_compile_cache()

    if args.config:
        cfg = AppConfig.from_file(args.config)
    else:
        cfg = AppConfig(
            scene=args.scene, width=args.width, height=args.height,
            spp=args.spp, frames=args.frames, max_bounces=args.max_bounces,
            animate=args.animate, rebuild_bvh=args.rebuild_bvh,
            focal_length=args.focal_length, defocus_angle=args.defocus_angle,
            backend=args.backend, shard=args.shard, output=args.output,
            metrics_jsonl=args.metrics_jsonl, checkpoint=args.checkpoint,
            resume=args.resume, wave_stats=args.wave_stats,
            compact=args.compact, defer=args.defer_paths,
            wave_limit=args.wave_limit,
            ladder=args.ladder, ladder_shrink=args.ladder_shrink,
            pixel_order=args.pixel_order,
            frames_in_flight=args.frames_in_flight,
        )
    run(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
