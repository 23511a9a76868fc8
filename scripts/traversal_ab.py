#!/usr/bin/env python
"""Traversal A/B on one GPU: the Pallas kernel (accel/gpu_traverse.py)
against what XLA makes of the lockstep walk (accel/traverse.py).

    python scripts/traversal_ab.py [--sweep] [--frames]

1. one traversal call of the indoor scene at bench width (512x512 =
   262,144 rays), primary rays and wave-2 bounce rays, closest-hit and
   any-hit: median device time of each, kernel and XLA walk;
2. ``--sweep``: the kernel's block size (rays per program, one ray per
   thread) over the same four calls;
3. ``--frames``: whole bench frames (512x512 @ 16 spp) with each traversal
   in turn (kernel, walk, walk, kernel), with each render's compile time.

Prints one line per number beside the card's name and power limit, and
writes them all to chiprun_out/traversal_ab.json.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def median_time(fn, reps: int = 5) -> float:
    """Median seconds of ``fn()`` after one warm-up call."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def per_call(host, rays, walk_fns: dict) -> dict:
    """{(walk, rays, mode): seconds} for one traversal call each."""
    import jax
    import jax.numpy as jnp

    trace = jax.device_put(host.render_scene.trace)
    out = {}
    for name, (o, d, act) in rays.items():
        t_max = jnp.full(o.shape[0], 1e30, jnp.float32)
        for any_hit in (False, True):
            mode = "anyhit" if any_hit else "closest"
            for walk, fn in walk_fns.items():
                out[f"{walk}/{name}/{mode}"] = median_time(
                    lambda: fn(trace, o, d, t_max, act, any_hit))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--frames", action="store_true")
    args = p.parse_args(argv)

    import jax

    import bench
    from surf_tpu.accel import gpu_traverse
    from surf_tpu.accel.traverse import traverse
    from surf_tpu.scene import builtin
    from surf_tpu.scene.compile import HostCompiled
    from surf_tpu.utils import (card_name_and_power_limit, require_gpu,
                                use_compile_cache)
    from surf_tpu.wavefront import integrator

    use_compile_cache()
    try:
        dev = require_gpu()[0]
    except RuntimeError as e:
        print(f"traversal_ab: {e}", file=sys.stderr)
        return 1
    card = card_name_and_power_limit()
    results = {"card": card, "device_kind": dev.device_kind,
               "block_rays": gpu_traverse.BLOCK_RAYS}

    def report(key, value):
        results[key] = value
        print(f"{key} = {value} | card: {card}", flush=True)

    host = HostCompiled(builtin.make_indoor_scene())
    rays = bench.traversal_rays(host)
    for name, (_, _, act) in rays.items():
        report(f"active_rays/{name}", int(act.sum()))
    xla_walk = jax.jit(traverse, static_argnums=(5,))
    for key, s in per_call(host, rays, {
            "kernel": gpu_traverse.traverse_gpu, "xla": xla_walk}).items():
        report(f"call_ms/{key}", s * 1e3)

    if args.sweep:
        default = (gpu_traverse.BLOCK_RAYS, gpu_traverse.NUM_WARPS)
        for block, warps in [(32, 1), (64, 2), (128, 4), (256, 8),
                             (128, 2), (256, 4)]:
            gpu_traverse.BLOCK_RAYS, gpu_traverse.NUM_WARPS = block, warps
            jax.clear_caches()
            for key, s in per_call(host, rays, {
                    "kernel": gpu_traverse.traverse_gpu}).items():
                report(f"sweep_ms/b{block}w{warps}/{key}", s * 1e3)
        gpu_traverse.BLOCK_RAYS, gpu_traverse.NUM_WARPS = default
        jax.clear_caches()

    if args.frames:
        walks = {"kernel": gpu_traverse.traverse_gpu, "xla": traverse}
        for i, walk in enumerate(["kernel", "xla", "xla", "kernel"]):
            jax.clear_caches()
            integrator.traversal_for = lambda platform, f=walks[walk]: f
            r = bench.run_bench(frames=1)
            for k in ("frame_time_s", "compile_s", "rays_per_s", "energy",
                      "peak_bytes_in_use"):
                report(f"frame{i}/{walk}/{k}", r[k])

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "traversal_ab.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
