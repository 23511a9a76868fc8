"""End-to-end image parity: scalar golden vs vectorized oracle vs JAX
wavefront path (SURVEY.md §4 dual-implementation-as-oracle strategy,
BASELINE configs 1-2 at reduced resolution)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

from surf_tpu.reference.cpu_renderer import OracleRenderer
from surf_tpu.reference.scalar import ScalarRenderer
from surf_tpu.scene import builtin
from surf_tpu.scene.camera import CameraParams
from surf_tpu.scene.compile import HostCompiled
from surf_tpu.wavefront import RenderConfig, render_frame_jit

warnings.filterwarnings("ignore", category=RuntimeWarning)


@pytest.fixture(scope="module")
def box():
    scene = builtin.make_diffuse_box_scene()
    return HostCompiled(scene)


@pytest.fixture(scope="module")
def indoor():
    scene = builtin.make_indoor_scene()
    return HostCompiled(scene)


def test_scalar_vs_vectorized_oracle_bitlevel(box):
    """The vectorized oracle must replicate the sequential per-pixel RNG
    streams of the literal C++ transcription to float ulps."""
    cam = builtin.make_indoor_camera(8, 8)
    img_s = ScalarRenderer(box, cam).render(8, 8, 2)
    img_v = OracleRenderer(box, cam).render(8, 8, 2)
    assert np.abs(img_s - img_v).max() < 1e-5


def test_scalar_vs_vectorized_branch_pixels(indoor):
    """Bit-level scalar-vs-vectorized agreement on pixels that PROVABLY
    exercise the dielectric (Fresnel/refract/medium), specular, NEE and RR
    branches (VERDICT r4 item 6): the indoor scene's lens, mirror cubes and
    diffuse walls, selected by classifying each pixel's first hit with the
    oracle's own primary rays.  The original 8x8 box test only covers these
    branches statistically."""
    import surf_tpu.reference.rng_np as R

    W = H = 48
    cam = builtin.make_indoor_camera(W, H)
    orc = OracleRenderer(indoor, cam)
    host = indoor

    # Classify every pixel by its first-hit material lobe.
    lane = np.arange(W * H, dtype=np.int64)
    py, px = np.divmod(lane, W)
    seed = R.pixel_seed(lane, 0)
    seed, o, d = orc._primary_rays(seed, px, py)
    prim, _, _, _ = orc._closest(
        o, d, np.full(W * H, 1e30, np.float32), np.ones(W * H, bool))
    found = prim >= 0
    inst = host.tri_inst[np.maximum(prim, 0)]
    mat = host.inst_material[inst]
    refl = host.materials.reflectivity[mat]
    refr = host.materials.refractivity[mat]
    classes = {
        "dielectric": found & (refr > 0),
        "specular": found & (refl > 0) & (refr == 0),
        "diffuse_nee_rr": found & (refl == 0) & (refr == 0)
        & ~host.materials.is_light[mat],
    }
    pixels = []
    for name, mask in classes.items():
        idx = np.where(mask)[0]
        assert len(idx), f"no pixel hits a {name} surface at {W}x{H}"
        # median index = most central candidate (robust to AA jitter)
        pixels.append(int(idx[len(idx) // 2]))

    spp = 4
    sel = np.asarray(pixels, np.int64)
    sel_py, sel_px = np.divmod(sel, W)

    # Vectorized oracle on exactly those lanes (per-pixel streams are
    # independent, so a lane subset is the same computation).
    seed_v = R.pixel_seed(sel, 0)
    acc_v = np.zeros((len(sel), 3), np.float32)
    for _ in range(spp):
        seed_v, o_v, d_v = orc._primary_rays(seed_v, sel_px, sel_py)
        seed_v, e_v = orc._trace(seed_v, o_v, d_v)
        acc_v += e_v

    # Literal scalar transcription, pixel at a time.
    sr = ScalarRenderer(host, cam)
    acc_s = np.zeros((len(sel), 3), np.float32)
    for k, (x, y) in enumerate(zip(sel_px, sel_py)):
        sr.seed = int(R.pixel_seed(int(x) + int(y) * W, 0))
        for _ in range(spp):
            o_s, d_s = sr._primary_ray(int(x), int(y))
            acc_s[k] += sr.trace(o_s, d_s)

    assert np.abs(acc_s - acc_v).max() < 1e-4, (pixels, acc_s, acc_v)


def test_wavefront_matches_oracle_box(box):
    """Config-1-shaped gate: diffuse box scene, fixed seed, thin-lens camera;
    the jitted wavefront renderer must match the NumPy oracle closely
    (identical RNG streams; only libm/FMA ulp noise allowed)."""
    W = H = 32
    spp = 2
    cam = builtin.make_indoor_camera(W, H)
    img_o = OracleRenderer(box, cam).render(W, H, spp)
    cfg = RenderConfig.for_scene(box.static, W, H, spp, use_defocus=True)
    img_j = np.asarray(
        render_frame_jit(box.render_scene, cfg, CameraParams.from_camera(cam),
                         jnp.uint32(0))
    )
    diff = np.abs(img_o - img_j).max(axis=2)
    assert (diff > 1e-3).mean() < 0.01, diff.max()
    assert abs(img_o.sum() - img_j.sum()) / abs(img_o.sum()) < 0.01


def test_wavefront_matches_oracle_indoor(indoor):
    """Config-2-shaped: full indoor scene (dielectric, specular, NEE, RR).
    Deep-path float chaos diverges a few pixels; the acceptance criterion is
    the one the reference itself uses across its CPU/GPU pair: overwhelming
    per-pixel agreement + energy ('Lumen') agreement."""
    W = H = 24
    spp = 2
    cam = builtin.make_indoor_camera(W, H)
    img_o = OracleRenderer(indoor, cam).render(W, H, spp)
    cfg = RenderConfig.for_scene(indoor.static, W, H, spp, use_defocus=True)
    img_j = np.asarray(
        render_frame_jit(indoor.render_scene, cfg, CameraParams.from_camera(cam),
                         jnp.uint32(0))
    )
    diff = np.abs(img_o - img_j).max(axis=2)
    assert (diff > 1e-3).mean() < 0.10
    assert abs(img_o.sum() - img_j.sum()) / abs(img_o.sum()) < 0.05


def test_wavefront_matches_oracle_indoor_high_spp(indoor):
    """Tightened statistical gate (VERDICT r1 item 8): at 16 spp the
    per-pixel Monte-Carlo noise averages down, so a systematic estimator
    bug (e.g. a wrong Fresnel branch taken a few % of the time) cannot
    hide inside the loose low-spp tolerances.  The metric is image-level:
    per-pixel divergence COUNTS grow with spp (each extra path is another
    chance of a legitimate ulp-induced decision flip) while their
    magnitude averages down, so the gate is relative L1 + energy
    (measured 1.4% / 0.35% on CPU; a systematic few-percent estimator bug
    shifts L1 by its full size and fails)."""
    W = H = 16
    spp = 16
    cam = builtin.make_indoor_camera(W, H)
    img_o = OracleRenderer(indoor, cam).render(W, H, spp)
    cfg = RenderConfig.for_scene(indoor.static, W, H, spp, use_defocus=True)
    img_j = np.asarray(
        render_frame_jit(indoor.render_scene, cfg,
                         CameraParams.from_camera(cam), jnp.uint32(0))
    )
    rel_l1 = np.abs(img_o - img_j).mean() / img_o.mean()
    assert rel_l1 < 0.03, rel_l1
    assert abs(img_o.sum() - img_j.sum()) / abs(img_o.sum()) < 0.01


def test_determinism_same_seed(box):
    """Same seed => identical image bits across runs (SURVEY.md §5.2)."""
    W = H = 16
    cam = builtin.make_indoor_camera(W, H)
    cfg = RenderConfig.for_scene(box.static, W, H, 2, use_defocus=True)
    cp = CameraParams.from_camera(cam)
    a = np.asarray(render_frame_jit(box.render_scene, cfg, cp, jnp.uint32(0)))
    b = np.asarray(render_frame_jit(box.render_scene, cfg, cp, jnp.uint32(0)))
    assert np.array_equal(a, b)


def test_morton_pixel_order_bit_identical(box):
    """cfg.pixel_order="morton" is a pure lane->pixel permutation: the
    image AND the per-pixel seed streams are bit-identical to native order
    (the permutation only changes which pixels share a traversal packet)."""
    from surf_tpu.wavefront.integrator import (initial_seeds,
                                               render_frame_seeded)

    W = H = 16
    cam = builtin.make_indoor_camera(W, H)
    cp = CameraParams.from_camera(cam)
    base = RenderConfig.for_scene(
        box.static, W, H, 2, use_defocus=True,
    )._replace(max_bounces=None, wave_limit=16, compact=True,
               ladder=2, ladder_shrink=2)
    outs = {}
    for order in ("native", "morton"):
        cfg = base._replace(pixel_order=order)
        seed = initial_seeds(cfg, jnp.uint32(0))
        img, s2 = render_frame_seeded(box.render_scene, cfg, cp, seed)
        outs[order] = (np.asarray(img), np.asarray(s2))
    assert np.array_equal(outs["native"][0], outs["morton"][0])
    assert np.array_equal(outs["native"][1], outs["morton"][1])


def test_progressive_accumulation_stream(box):
    """totalSamples advances the per-pixel seed stream (renderer.cpp:169):
    frames at different totalSamples must differ."""
    W = H = 16
    cam = builtin.make_indoor_camera(W, H)
    cfg = RenderConfig.for_scene(box.static, W, H, 1, use_defocus=True)
    cp = CameraParams.from_camera(cam)
    a = np.asarray(render_frame_jit(box.render_scene, cfg, cp, jnp.uint32(0)))
    b = np.asarray(render_frame_jit(box.render_scene, cfg, cp, jnp.uint32(1)))
    assert not np.array_equal(a, b)


def test_bounded_matches_unbounded_within_noise(box):
    """A bounce cap of 48 is statistically indistinguishable from the
    unbounded while_loop (RR kills survivors long before)."""
    W = H = 16
    cam = builtin.make_indoor_camera(W, H)
    cp = CameraParams.from_camera(cam)
    cfg_u = RenderConfig.for_scene(box.static, W, H, 2, use_defocus=True)
    cfg_b = cfg_u._replace(max_bounces=48)
    a = np.asarray(render_frame_jit(box.render_scene, cfg_u, cp, jnp.uint32(0)))
    b = np.asarray(render_frame_jit(box.render_scene, cfg_b, cp, jnp.uint32(0)))
    assert np.abs(a - b).max() < 1e-4
