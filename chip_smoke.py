#!/usr/bin/env python
"""Smoke test of the renderer on one NVIDIA GPU, through its normal entry
points, at the sizes users run.  One process drives the card.

    python chip_smoke.py               # phases 1-6 on one card
    python chip_smoke.py --four-cards  # the sharded render + gradient on 4

Phases (each prints its numbers beside the card's name and power limit;
any failure exits non-zero before the result line):

1. device: JAX platform, kind and count, and ``nvidia-smi``'s card line;
2. traversal parity at bench width: the compiled kernel on the card against
   the XLA walk on the CPU device of this process (primary and wave-2
   rays of the 512x512 bench frame, closest-hit and any-hit);
3. the bench frame, indoor 512x512 @ 16 spp, through bench.py's own code;
4. estimator parity: indoor 64x64 @ 16 spp against the NumPy oracle (its
   row bands rendered by CPU worker processes that stay off the card);
5. the reference's interactive shape, 1280x720 @ 1 spp x 3 frames, through
   ``surf_tpu.app.cli.main`` in this process;
6. an albedo + camera gradient step at 128x128, and its gradients at 32x32
   against the same step on the CPU device.

``--four-cards`` runs only the multi-card path: ``render_frame_sharded``
and ``grad_step_sharded`` on a 1-D ('chips',) mesh of 4 cards at
512x512 @ 4 spp, each against the same call on one card.

The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

OUT = Path(__file__).resolve().parent / "chiprun_out"
ORACLE_WORKERS = 8
CARD = ""


def say(phase: str, **numbers) -> None:
    fields = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{phase}] {fields} | card: {CARD}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- phase 1
def phase_device(expected_count: int | None = None):
    import jax

    from surf_tpu.utils import card_name_and_power_limit, require_gpu

    global CARD
    devices = require_gpu()
    CARD = card_name_and_power_limit()
    print(CARD, flush=True)
    say("1 device", platform=devices[0].platform,
        kind=repr(devices[0].device_kind), count=len(devices),
        jax=jax.__version__)
    if expected_count is not None:
        check(len(devices) >= expected_count,
              f"need {expected_count} cards, found {len(devices)}")
    return devices


# ---------------------------------------------------------------- phase 2
def phase_traversal_parity(host):
    import jax
    import numpy as np

    import bench
    from surf_tpu.accel.traverse import traverse
    from surf_tpu.accel.gpu_traverse import traverse_gpu

    cpu = jax.devices("cpu")[0]
    xla_walk = jax.jit(traverse, static_argnums=(5,))
    trace_gpu = jax.device_put(host.render_scene.trace)
    trace_cpu = jax.device_put(host.render_scene.trace, cpu)
    for name, (o, d, act) in bench.traversal_rays(host).items():
        n = int(o.shape[0])
        t_max = jax.numpy.full(n, 1e30, jax.numpy.float32)
        for any_hit in (False, True):
            t0 = time.perf_counter()
            h = jax.block_until_ready(
                traverse_gpu(trace_gpu, o, d, t_max, act, any_hit))
            first_s = time.perf_counter() - t0
            with jax.default_device(cpu):
                ref = xla_walk(trace_cpu, *jax.device_put((o, d, t_max, act),
                                                          cpu), any_hit)
            active = np.asarray(act)
            prim, prim_ref = np.asarray(h.prim), np.asarray(ref.prim)
            if any_hit:
                agree = (prim >= 0) == (prim_ref >= 0)
            else:
                agree = prim == prim_ref
            frac = agree[active].mean()
            t, t_ref = np.asarray(h.t), np.asarray(ref.t)
            both = agree & active & (prim_ref >= 0)
            if any_hit:
                both &= prim == prim_ref
            dt_rel = (np.abs(t - t_ref) / np.maximum(1.0, np.abs(t_ref)))[both]
            max_dt = float(dt_rel.max()) if dt_rel.size else 0.0
            say(f"2 parity {name} {'anyhit' if any_hit else 'closest'}",
                rays=n, active=int(active.sum()),
                hit_frac=round(float((prim_ref >= 0)[active].mean()), 4),
                prim_agree=frac, prim_disagree=int((~agree[active]).sum()),
                max_rel_dt=max_dt, first_call_s=round(first_s, 3))
            check(frac >= 0.9999, f"prim agreement {frac} < 0.9999")
            check(max_dt <= 1e-5, f"|dt| {max_dt} > 1e-5 max(1, t)")


# ---------------------------------------------------------------- phase 3
def phase_bench():
    import bench

    r = bench.run_bench()
    say("3 bench frame 512x512@16spp", rays_per_s=r["rays_per_s"],
        frame_time_s=r["frame_time_s"], compile_s=r["compile_s"],
        energy=r["energy"], peak_bytes_in_use=r["peak_bytes_in_use"])
    return r


# ---------------------------------------------------------------- phase 4
def _oracle_band(args):
    """One row band of the oracle image, in a CPU-only worker process."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    from surf_tpu.reference.cpu_renderer import OracleRenderer
    from surf_tpu.scene import builtin
    from surf_tpu.scene.compile import HostCompiled

    width, height, spp, y0, y1 = args
    host = HostCompiled(builtin.make_indoor_scene())
    cam = builtin.make_indoor_camera(width, height)
    return OracleRenderer(host, cam).render_rows(width, y0, y1, spp)


def start_oracle(pool, width=64, height=64, spp=16):
    step = -(-height // ORACLE_WORKERS)
    bands = [(width, height, spp, y0, min(y0 + step, height))
             for y0 in range(0, height, step)]
    return [pool.submit(_oracle_band, b) for b in bands]


def phase_estimator_parity(host, oracle_futures, width=64, height=64,
                           spp=16):
    import jax.numpy as jnp
    import numpy as np

    from surf_tpu.scene import builtin
    from surf_tpu.scene.camera import CameraParams
    from surf_tpu.wavefront import RenderConfig, render_frame_jit

    cam = builtin.make_indoor_camera(width, height)
    cfg = RenderConfig.for_scene(host.static, width, height, spp,
                                 use_defocus=True)
    img = np.asarray(render_frame_jit(host.render_scene, cfg,
                                      CameraParams.from_camera(cam),
                                      jnp.uint32(0)))
    t0 = time.perf_counter()
    ref = np.concatenate([f.result() for f in oracle_futures])
    wait_s = time.perf_counter() - t0
    rel_l1 = float(np.abs(ref - img).mean() / ref.mean())
    energy_rel = float(abs(ref.sum() - img.sum()) / abs(ref.sum()))
    say("4 estimator parity 64x64@16spp", rel_l1=rel_l1,
        energy_rel=energy_rel, oracle_wait_s=round(wait_s, 1))
    check(np.isfinite(img).all(), "non-finite pixels")
    check(rel_l1 < 0.03, f"relative L1 {rel_l1} >= 3%")
    check(energy_rel < 0.01, f"energy error {energy_rel} >= 1%")


# ---------------------------------------------------------------- phase 5
def phase_cli():
    import numpy as np

    from surf_tpu.app import cli

    OUT.mkdir(exist_ok=True)
    out = OUT / "smoke_indoor_1280x720.npy"
    t0 = time.perf_counter()
    rc = cli.main(["--scene", "indoor", "--width", "1280", "--height", "720",
                   "--spp", "1", "--frames", "3", "--output", str(out)])
    wall = time.perf_counter() - t0
    img = np.load(out)
    say("5 cli indoor 1280x720@1spp x3", rc=rc, wall_s=round(wall, 2),
        energy=float(img.sum()))
    check(rc == 0, f"cli returned {rc}")
    check(img.shape == (720, 1280, 3), f"image shape {img.shape}")
    check(np.isfinite(img).all() and (img >= 0).all(), "bad image values")


# ---------------------------------------------------------------- phase 6
def _grad_step(host, size, device):
    import jax
    import jax.numpy as jnp

    from surf_tpu.diff import DiffTargets, grad_image_loss
    from surf_tpu.scene import builtin
    from surf_tpu.scene.camera import CameraParams
    from surf_tpu.wavefront import RenderConfig

    with jax.default_device(device):
        cam = CameraParams.from_camera(builtin.make_indoor_camera(size, size))
        cfg = RenderConfig.for_scene(host.static, size, size, 2,
                                     use_defocus=True)._replace(max_bounces=12)
        scene = jax.device_put(host.render_scene, device)
        targets = jax.device_put(DiffTargets.from_scene(scene, cam), device)
        t0 = time.perf_counter()
        loss, g = jax.block_until_ready(
            grad_image_loss(scene, cfg, targets, jnp.uint32(0)))
        first_s = time.perf_counter() - t0
        stepped = targets._replace(albedo=targets.albedo - 2.0 * g.albedo,
                                   camera=targets.camera._replace(
                                       position=targets.camera.position
                                       - 1e-2 * g.camera.position))
    return float(loss), g, stepped, first_s


def phase_grad(gpu):
    import jax
    import numpy as np

    from surf_tpu.scene import builtin
    from surf_tpu.scene.compile import HostCompiled

    box = HostCompiled(builtin.make_diffuse_box_scene())
    loss, g, stepped, first_s = _grad_step(box, 128, gpu)
    finite = all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(g))
    say("6 grad step 128x128", loss=loss, first_call_s=round(first_s, 2),
        grad_albedo_norm=float(np.linalg.norm(np.asarray(g.albedo))),
        finite=finite)
    check(finite and np.isfinite(loss) and loss > 0, "bad loss or gradient")
    check(all(np.isfinite(np.asarray(x)).all()
              for x in jax.tree.leaves(stepped)), "bad stepped targets")

    _, g_gpu, _, _ = _grad_step(box, 32, gpu)
    _, g_cpu, _, _ = _grad_step(box, 32, jax.devices("cpu")[0])
    a_gpu, a_cpu = np.asarray(g_gpu.albedo), np.asarray(g_cpu.albedo)
    p_gpu = np.asarray(g_gpu.camera.position)
    p_cpu = np.asarray(g_cpu.camera.position)
    # tolerances of tests/test_grads.py: albedo 5% + 1e-4, camera position
    # 60% + 1e-3
    alb_err = np.abs(a_gpu - a_cpu) - (0.05 * np.abs(a_cpu) + 1e-4)
    pos_err = np.abs(p_gpu - p_cpu) - (0.6 * np.abs(p_cpu) + 1e-3)
    say("6 grad 32x32 gpu vs cpu",
        max_albedo_diff=float(np.abs(a_gpu - a_cpu).max()),
        max_position_diff=float(np.abs(p_gpu - p_cpu).max()))
    check((alb_err <= 0).all(), "albedo gradient differs from the CPU's")
    check((pos_err <= 0).all(), "camera gradient differs from the CPU's")


# ------------------------------------------------------------ four cards
def phase_four_cards(devices, size=512, spp=4):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from surf_tpu.diff import DiffTargets, grad_image_loss
    from surf_tpu.dist import (ShardedSession, grad_step_sharded, make_mesh,
                               render_frame_sharded)
    from surf_tpu.scene import builtin
    from surf_tpu.scene.camera import CameraParams
    from surf_tpu.scene.compile import HostCompiled
    from surf_tpu.wavefront import render_frame_jit

    w = h = size
    host = HostCompiled(builtin.make_indoor_scene())
    cam = CameraParams.from_camera(builtin.make_indoor_camera(w, h))
    cfg = bench.bench_config(host.static, w, h, spp)._replace(
        pixel_order="native")
    mesh = make_mesh(4, devices[:4])

    def timed(fn, reps=2):
        out = jax.block_until_ready(fn())  # compile + warm-up
        t0 = time.perf_counter()
        for _ in range(reps):
            out = jax.block_until_ready(fn())
        return out, (time.perf_counter() - t0) / reps

    one, t_one = timed(lambda: render_frame_jit(
        host.render_scene, cfg, cam, jnp.uint32(0)))
    four, t_four = timed(lambda: render_frame_sharded(
        host.render_scene, cfg, cam, jnp.uint32(0), mesh))
    session = ShardedSession(host.render_scene, cfg, mesh)  # place once
    placed, t_placed = timed(lambda: session.render(cam, jnp.uint32(0)))
    check(np.array_equal(np.asarray(placed), np.asarray(four)),
          "ShardedSession differs from render_frame_sharded")
    one, four = np.asarray(one) / spp, np.asarray(four) / spp
    close = (np.abs(one - four).max(axis=2) <= 1e-4).mean()
    energy_rel = float(abs(one.sum() - four.sum()) / abs(one.sum()))
    say(f"4cards render {w}x{h}@{spp}spp", frame_s_1card=t_one,
        frame_s_4cards=t_four, frame_s_4cards_placed_once=t_placed,
        speedup_placed_once=t_one / t_placed,
        frac_pixels_within_1e_4=close, energy_rel=energy_rel)
    check(np.isfinite(four).all(), "non-finite sharded image")
    check(close >= 0.999, f"only {close} of pixels within 1e-4")
    check(energy_rel <= 1e-4, f"energy differs by {energy_rel}")

    gcfg = cfg._replace(max_bounces=6)
    targets = DiffTargets.from_scene(host.render_scene, cam)
    (l1, g1), t_g1 = timed(lambda: grad_image_loss(
        host.render_scene, gcfg, targets, jnp.uint32(0)))
    (l4, g4), t_g4 = timed(lambda: grad_step_sharded(
        host.render_scene, gcfg, targets, jnp.uint32(0), mesh))
    worst = 0.0
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g4)):
        a, b = np.asarray(a), np.asarray(b)
        check(np.isfinite(b).all(), "non-finite sharded gradient")
        scale = max(float(np.abs(a).max()), 1e-12)
        worst = max(worst, float(np.abs(a - b).max()) / scale)
    say(f"4cards grad {w}x{h}@{spp}spp", step_s_1card=t_g1, step_s_4cards=t_g4,
        loss_1card=float(l1), loss_4cards=float(l4), max_rel_grad_diff=worst)
    check(abs(float(l1) - float(l4)) <= 1e-3 * abs(float(l1)), "loss differs")
    check(worst <= 1e-3, f"gradients differ by {worst} relative")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded render + gradient on 4 cards")
    args = p.parse_args(argv)

    from surf_tpu.utils import use_compile_cache

    use_compile_cache()
    try:
        devices = phase_device(4 if args.four_cards else None)
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    if args.four_cards:
        phase_four_cards(devices)
    else:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        from surf_tpu.scene import builtin
        from surf_tpu.scene.compile import HostCompiled

        host = HostCompiled(builtin.make_indoor_scene())
        with ProcessPoolExecutor(ORACLE_WORKERS,
                                 mp_context=mp.get_context("spawn")) as pool:
            oracle = start_oracle(pool)
            phase_traversal_parity(host)
            phase_bench()
            phase_estimator_parity(host, oracle)
        phase_cli()
        phase_grad(devices[0])
    say("done", wall_s=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
