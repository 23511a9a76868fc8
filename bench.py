#!/usr/bin/env python
"""Headline benchmark: forward wavefront render of the built-in indoor scene
on one GPU.

    python bench.py

Prints the card (``nvidia-smi`` name and power limit) and then ONE JSON
line:
  {"metric": "rays_per_s", "value": N, "unit": "rays/s", "detail": {...}}

The metric matches the reference's runtime instrumentation
(reference/sources/main.cpp:430-431): primary samples per second
(W*H*spp / frame time), at 512x512 @ 16 spp (BASELINE config 2 shape).
``detail`` names the device (platform, kind, count, card) and reports the
frame time, the compile time of the render, the energy checksum and the
device's peak memory.  Without a GPU it exits non-zero and prints no
result: a measurement never falls back to the CPU.
"""

from __future__ import annotations

import json
import sys
import time

WIDTH = HEIGHT = 512
SPP = 16
WAVE_LIMIT = 32


def bench_config(static, width: int, height: int, spp: int):
    """The bench's RenderConfig.  The wave-loop settings are the values the
    renderer ran with before it came to the GPU, untuned there (ROADMAP
    S5): an unbounded wave loop capped at WAVE_LIMIT waves, compaction
    every 16th wave, a 6-rung width ladder halving per rung, Morton lane
    order.  Compaction, the ladder and Morton order only permute lanes, so
    the image is bit-identical to the plain loop's."""
    from surf_tpu.wavefront import RenderConfig

    return RenderConfig.for_scene(
        static, width, height, spp, use_defocus=True,
    )._replace(
        max_bounces=None, wave_limit=WAVE_LIMIT, compact=True,
        compact_every=16, ladder=6, ladder_shrink=2, pixel_order="morton",
    )


def traversal_rays(host, width: int = WIDTH, height: int = HEIGHT) -> dict:
    """The rays of single traversal calls at bench width, in the bench's
    lane order: ``"primary"`` (the first sample's camera rays) and
    ``"bounce"`` (the rays of wave 2, after one extend/shade/connect wave;
    lanes whose path ended are inactive).  Each is (origin, direction,
    active) on the default device."""
    import jax
    import jax.numpy as jnp

    from surf_tpu.core import rng
    from surf_tpu.scene import builtin
    from surf_tpu.scene.camera import CameraParams, view_plane_jnp
    from surf_tpu.wavefront import integrator

    cfg = bench_config(host.static, width, height, 1)
    cp = CameraParams.from_camera(builtin.make_indoor_camera(width, height))
    n = width * height
    pixel = integrator.lane_pixel_perm(cfg)
    seed = jnp.take(rng.pixel_seed(jnp.arange(n, dtype=jnp.uint32),
                                   jnp.uint32(0)), pixel)
    lane_pixel = pixel.astype(jnp.uint32)
    seed, o, d = integrator.ray_generation(
        cfg, view_plane_jnp(cp, width, height), seed,
        (lane_pixel % width).astype(jnp.int32),
        (lane_pixel // width).astype(jnp.int32))
    state = integrator.PathState(
        origin=o, direction=d, seed=seed,
        transmission=jnp.ones((n, 3), jnp.float32),
        energy=jnp.zeros((n, 3), jnp.float32),
        last_specular=jnp.ones(n, bool), in_medium=jnp.zeros(n, bool),
        alive=jnp.ones(n, bool), pixel=pixel)
    wave2 = jax.jit(integrator.bounce_step, static_argnums=1)(
        jax.device_put(host.render_scene), cfg, state)
    return {"primary": (o, d, state.alive),
            "bounce": (wave2.origin, wave2.direction, wave2.alive)}


def run_bench(width: int = WIDTH, height: int = HEIGHT, spp: int = SPP,
              frames: int = 2) -> dict:
    """Compile, warm up, then time ``frames`` frames of the indoor scene on
    the default device; returns the measurements (times in seconds)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from surf_tpu.scene import builtin
    from surf_tpu.scene.camera import CameraParams
    from surf_tpu.scene.compile import HostCompiled
    from surf_tpu.wavefront import render_frame_jit

    host = HostCompiled(builtin.make_indoor_scene())
    scene = jax.device_put(host.render_scene)
    cp = CameraParams.from_camera(builtin.make_indoor_camera(width, height))
    cfg = bench_config(host.static, width, height, spp)

    t0 = time.perf_counter()
    render = render_frame_jit.lower(scene, cfg, cp, jnp.uint32(0)).compile()
    compile_s = time.perf_counter() - t0

    img = jax.block_until_ready(render(scene, cp, jnp.uint32(0)))  # warm-up
    t0 = time.perf_counter()
    for i in range(frames):
        img = render(scene, cp, jnp.uint32((i + 1) * spp))
    jax.block_until_ready(img)
    dt = (time.perf_counter() - t0) / frames

    img = np.asarray(img) / spp
    if not (np.isfinite(img).all() and (img >= 0).all()):
        raise RuntimeError("render produced non-finite or negative radiance")
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "rays_per_s": width * height * spp / dt,
        "frame_time_s": dt,
        "compile_s": compile_s,
        "energy": float(img.sum()),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "config": {"width": width, "height": height, "spp": spp,
                   "wave_limit": WAVE_LIMIT, "frames": frames},
    }


def main() -> int:
    from surf_tpu.utils import (card_name_and_power_limit, require_gpu,
                                use_compile_cache)

    use_compile_cache()
    try:
        devices = require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    card = card_name_and_power_limit()
    print(f"card: {card}")
    r = run_bench()
    print(json.dumps({
        "metric": "rays_per_s",
        "value": r.pop("rays_per_s"),
        "unit": "rays/s",
        "detail": {
            "platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices),
            "card": card,
            **r,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
