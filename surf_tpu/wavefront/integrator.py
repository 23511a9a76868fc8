"""The wavefront path-tracing integrator.

A JAX redesign of the reference's five-kernel wavefront pipeline
(reference/shaders/ray_generation.comp, ray_extend.comp, ray_shade.comp,
ray_connect.comp, wavefront_finalize.comp and the host wave loop
renderer.cpp:939-1157).  Design deltas, per SURVEY.md §2/§7:

- The reference's atomic work queues + CPU-orchestrated wave loop (a fence
  round-trip per wave) become ONE jitted bounce loop entirely on device:
  dense SoA lane state, masked stages, ``lax.while_loop`` until every path
  has terminated (or ``lax.fori_loop`` with a static bounce cap for the
  differentiable estimator, since reverse-mode AD cannot cross while_loop).
- Queues are dense: every pixel owns exactly one path per sample, so
  ray_generation needs no atomics; dead lanes are masked, and optionally
  compacted to the front (``compact_paths``) or retired by the width
  ladder (``_bounce_loop_ladder``).
- The per-stage RNG consumption order replicates the *CPU* renderer
  (renderer.cpp:331-463) exactly — per-pixel sequential streams — which is
  the parity target (SURVEY.md §7.3.5): lanes advance their seed only when
  the sequential code would.
- Traversal is detached (hit ids only); the chosen triangle is re-intersected
  differentiably so pixel gradients flow to camera pose, vertices and
  materials without differentiating through the traversal loop.  The
  traversal itself is picked per platform by ``accel.select``: the Pallas
  kernel of ``accel/gpu_traverse.py`` on a GPU, the XLA walk of
  ``accel/traverse.py`` on the CPU.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..accel.gpu_traverse import BLOCK_RAYS
from ..accel.select import default_platform, traversal_for
from ..core import rng, sampling
from ..core.vecmath import (
    F32_EPSILON,
    F32_FAR_AWAY,
    F32_INV_PI,
    dot,
    normalize,
    reflect,
)
from ..scene.camera import CameraParams, ViewPlane, view_plane_jnp
from ..scene.compile import RenderScene, SceneStatic


class RenderConfig(NamedTuple):
    """Static (hashable) render configuration — jit-static argument."""

    width: int
    height: int
    spp: int
    use_defocus: bool
    num_lights: int
    max_bounces: int | None = None  # None -> unbounded while_loop (forward only)
    # Wave cap for the unbounded loop.  The reference never bounds path
    # length, but RR only applies to diffuse lanes (renderer.cpp:446), so a
    # handful of paths trapped between specular/dielectric surfaces can
    # outlive everything else by thousands of waves; on the indoor scene an
    # uncapped loop runs ~8000 near-empty zombie waves for <1e-4 of the
    # image energy (transmission decays as albedo^bounces).  128 waves keeps
    # the bias far below noise.
    wave_limit: int = 128
    defer_drain: int = 64           # wave cap for the deferred-pool
                                    # continuation (deeper than wave_limit:
                                    # the pool runs ONCE per frame at pooled
                                    # occupancy, so draining it fully is
                                    # cheap and keeps inflow < outflow)
    compact: bool = False           # partition live paths to the front
    ladder: int = 0                 # width-ladder steps: after live count
                                    # drops below 1/shrink width, retire
                                    # dead lanes and continue the wave loop
                                    # at 1/shrink the dispatch width
                                    # (repeated; forward unbounded mode)
    ladder_shrink: int = 4          # ladder width divisor per rung
    pixel_order: str = "native"     # lane->pixel mapping: "native" row-major
                                    # or "morton" (Z-order).  Morton makes
                                    # every aligned block of lanes a compact
                                    # pixel tile instead of a thin scanline,
                                    # so the rays of one traversal block
                                    # take similar BVH paths.  Pure lane
                                    # permutation: per-pixel RNG streams and
                                    # the image are bit-identical.
    compact_every: int = 4          # ... on every k-th wave (the
                                    # cumsum+scatter cost scales with lane
                                    # count)
    remat: bool = False             # checkpoint each wave (reverse-mode memory)
    rr: bool = True                 # Russian roulette (off: FD gradient gate
                                    # — RR's detached kill boundary is the
                                    # discrete term that separates FD of the
                                    # estimator from its AD derivative)

    @classmethod
    def for_scene(
        cls, static: SceneStatic, width: int, height: int, spp: int,
        use_defocus: bool, max_bounces: int | None = None,
    ) -> "RenderConfig":
        return cls(
            width=width, height=height, spp=spp, use_defocus=use_defocus,
            num_lights=static.num_lights, max_bounces=max_bounces,
        )


class PathState(NamedTuple):
    """Dense SoA lane state — the analog of the reference's GPURay AoS
    buffers (headers/ray.h:22-31), split per field (SURVEY.md §2 Ray types).
    ``pixel`` tracks the owning pixel so compaction can permute lanes (the
    GPURayState.pixelIdx analog, ray.h:12)."""

    origin: jnp.ndarray        # [N,3]
    direction: jnp.ndarray     # [N,3]
    seed: jnp.ndarray          # [N] uint32
    transmission: jnp.ndarray  # [N,3]
    energy: jnp.ndarray        # [N,3]
    last_specular: jnp.ndarray # [N] bool
    in_medium: jnp.ndarray     # [N] bool
    alive: jnp.ndarray         # [N] bool
    pixel: jnp.ndarray         # [N] int32


def compact_paths(state: PathState) -> PathState:
    """Stream compaction: stable-partition lanes so live paths are
    contiguous at the front — the dense-lane replacement for the
    reference's atomicAdd work queues (SURVEY.md §2.3 P3 'compaction via
    sort/prefix-sum').  Traversal blocks whose lanes are all dead exit at
    once, so the long tail of waves (trapped specular paths decay slowly —
    RR only kills diffuse lanes, renderer.cpp:446) stops paying for a
    handful of live rays spread over the whole width.

    The partition is built from two cumsums and ONE int32 scatter, then
    applied as gathers (no sort).  It is stable, so the live prefix stays
    in pixel order (primary-ray coherence is preserved for free).  RNG
    parity is unaffected — each path carries its own seed stream, and
    lanes are restored to pixel order at the end of the sample
    (render_sample)."""
    alive = state.alive
    n = alive.shape[0]
    live_i = alive.astype(jnp.int32)
    c_live = jnp.cumsum(live_i)
    n_live = c_live[-1]
    c_dead = jnp.cumsum(jnp.int32(1) - live_i)
    pos = jnp.where(alive, c_live - 1, n_live + c_dead - 1)
    perm = jnp.zeros(n, jnp.int32).at[pos].set(
        jnp.arange(n, dtype=jnp.int32), unique_indices=True,
        indices_are_sorted=False,
    )
    return jax.tree.map(lambda x: jnp.take(x, perm, axis=0), state)


# --------------------------------------------------------------------------
# Stage 1: ray generation (ray_generation.comp:30-80, camera.h:59-87)
# --------------------------------------------------------------------------

def ray_generation(
    cfg: RenderConfig, vp: ViewPlane, seed: jnp.ndarray,
    px: jnp.ndarray, py: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """AA-jittered thin-lens primary rays; one per lane (dense queue)."""
    ones = jnp.ones_like(seed, dtype=bool)
    seed, jx = rng.next_f32(seed)
    seed, jy = rng.next_f32(seed)
    fx = px.astype(jnp.float32) + (jx - jnp.float32(0.5))
    fy = py.astype(jnp.float32) + (jy - jnp.float32(0.5))
    u = fx * jnp.float32(1.0 / cfg.width)
    v = fy * jnp.float32(1.0 / cfg.height)

    if cfg.use_defocus:
        radius = vp.focal_length * jnp.tan(
            _radians(vp.defocus_angle / jnp.float32(2.0))
        )
        du = vp.right * radius
        dv = jnp.float32(-1.0) * vp.up * radius
        seed, su, sv = sampling.unit_disk(seed, ones)
        origin = vp.position + su[:, None] * du + sv[:, None] * dv
    else:
        origin = jnp.broadcast_to(vp.position, (seed.shape[0], 3))

    plane = vp.first_pixel + u[:, None] * vp.u_vector + v[:, None] * vp.v_vector
    direction = normalize(plane - origin)
    return seed, origin, direction


def _radians(deg):
    return (deg * jnp.float32(3.14159265358979323846264)) * jnp.float32(
        0.005555555555555
    )


# --------------------------------------------------------------------------
# Stage 2-4: extend / shade / connect fused into one masked bounce step
# --------------------------------------------------------------------------

def _dispatch_traverse(trace, origin, direction, t_max, active,
                       any_hit: bool):
    """Detached BVH traversal with the platform's traversal
    (``accel.select``): identical semantics on every platform."""
    traverse = traversal_for(default_platform())
    return traverse(trace, origin, direction, t_max, active, any_hit=any_hit)


def _sample_background(scene: RenderScene, direction):
    """Scene::sampleBackground (scene.cpp:35-51)."""
    alpha = jnp.float32(0.5) * (jnp.float32(1.0) + direction[:, 1])
    grad = (
        alpha[:, None] * scene.bg_gradient_b
        + (jnp.float32(1.0) - alpha)[:, None] * scene.bg_gradient_a
    )
    solid = jnp.broadcast_to(scene.bg_color, direction.shape)
    return jnp.where(scene.bg_type == 1, grad, solid)


def _emittance(scene: RenderScene, mat):
    return scene.mat_emission_strength[mat, None] * scene.mat_emission_color[mat]


def bounce_step(scene: RenderScene, cfg: RenderConfig, s: PathState) -> PathState:
    """One wave: extend (closest hit) -> shade (lobes, NEE) -> connect
    (occlusion) -> bounce-ray update, all masked over dense lanes."""
    n = s.origin.shape[0]
    sg = jax.lax.stop_gradient

    # ---- EXTEND (ray_extend.comp / bvh.cpp traversal), detached ----------
    # The trace arrays are detached too so vertex-perturbed scenes never leak
    # tangents into the traversal while_loop (no transpose rule exists).
    hit = _dispatch_traverse(
        jax.tree.map(sg, scene.trace),
        sg(s.origin), sg(s.direction),
        jnp.full(n, F32_FAR_AWAY, jnp.float32),
        s.alive,
        any_hit=False,
    )
    prim = hit.prim
    found = prim >= 0

    # Differentiable re-intersection of the chosen triangle (camera/vertex
    # gradients flow here; the traversal only chose *which* triangle).
    slot = jnp.maximum(prim, 0)
    g = jnp.take(scene.perm, slot)  # original-order triangle id
    inst = jnp.take(scene.tri_inst, slot)
    v0 = jnp.take(scene.samp_v0, g, axis=0)
    v1 = jnp.take(scene.samp_v1, g, axis=0)
    v2 = jnp.take(scene.samp_v2, g, axis=0)
    n0_ = jnp.take(scene.samp_n0, g, axis=0)
    n1_ = jnp.take(scene.samp_n1, g, axis=0)
    n2_ = jnp.take(scene.samp_n2, g, axis=0)
    t, u, v = _reintersect(s.origin, s.direction, v0, v1, v2)

    miss = s.alive & ~found
    energy = jnp.where(
        miss[:, None],
        s.energy + s.transmission * _sample_background(scene, s.direction),
        s.energy,
    )
    alive = s.alive & found

    mat = jnp.take(scene.inst_material, inst)

    # ---- light hit termination (ray_shade.comp:64-69, renderer.cpp:348-352)
    hit_light = alive & jnp.take(scene.mat_is_light, mat)
    lit = hit_light & s.last_specular
    energy = jnp.where(
        lit[:, None], energy + s.transmission * _emittance(scene, mat), energy
    )
    alive = alive & ~hit_light

    # ---- SHADE (ray_shade.comp:71-189, renderer.cpp:354-459) -------------
    # Miss lanes re-intersect slot 0 with an unrelated ray: _reintersect's
    # f = 1/a can make t/u/v +-inf there.  The inf reaches NaN primals
    # inside masked branches (exp(0 * -inf), normalize(inf*n) = inf/inf),
    # and although jnp.where masks the PRIMAL, the chain rule multiplies
    # the zeroed cotangent by the NaN partial — 0*NaN = NaN — which then
    # scatter-adds into material AND camera gradients (measured: NaN AD
    # for the dielectric/specular rows on the indoor scene at
    # max_bounces>=3, round 5).  Every downstream consumer is masked by
    # alive ⊆ found, so substituting neutral values on miss lanes is
    # primal-identical and keeps every partial finite.
    t = jnp.where(found, t, jnp.float32(0.0))
    u = jnp.where(found, u, jnp.float32(0.25))
    v = jnp.where(found, v, jnp.float32(0.25))
    medium_scale = jnp.where(
        s.in_medium[:, None],
        jnp.exp(jnp.take(scene.mat_absorption, mat, axis=0) * -t[:, None]),
        jnp.float32(1.0),
    )
    I = s.origin + t[:, None] * s.direction
    N = (
        u[:, None] * n0_
        + v[:, None] * n2_
        + (jnp.float32(1.0) - u - v)[:, None] * n1_
    )
    N = normalize(N)

    seed, r_lobe = rng.next_f32_masked(s.seed, alive)
    N = jnp.where(dot(s.direction, N)[:, None] > 0, -N, N)

    refl = jnp.take(scene.mat_reflectivity, mat)
    refr = jnp.take(scene.mat_refractivity, mat)
    albedo = jnp.take(scene.mat_albedo, mat, axis=0)
    m_spec = alive & (r_lobe < refl)
    m_diel = alive & ~m_spec & (r_lobe < refl + refr)
    m_diff = alive & ~m_spec & ~m_diel

    refl_dir = reflect(s.direction, N)
    r_out = jnp.zeros_like(s.direction)
    new_trans = s.transmission
    new_last_spec = s.last_specular
    new_in_medium = s.in_medium

    # specular mirror
    r_out = jnp.where(m_spec[:, None], refl_dir, r_out)
    spec_trans = s.transmission * albedo * medium_scale
    new_trans = jnp.where(m_spec[:, None], spec_trans, new_trans)
    new_last_spec = jnp.where(m_spec, True, new_last_spec)

    # dielectric with Schlick Fresnel (renderer.cpp:376-406)
    # Non-dielectric materials carry ior = 0, so n2 = 0 on their lanes and
    # ior_ratio = inf -> refract_dir partials are inf; the masked where's
    # backward multiplies the zeroed cotangent by that inf partial (0*inf
    # = NaN) and the NaN rides the DIRECTION cotangent back through every
    # earlier wave, poisoning camera + all-material gradients (measured on
    # the indoor scene at max_bounces>=3, round 5).  ior is only consumed
    # on m_diel lanes, so substituting 1 elsewhere is primal-identical.
    ior = jnp.where(m_diel, jnp.take(scene.mat_ior, mat), jnp.float32(1.0))
    n1 = jnp.where(s.in_medium, ior, jnp.float32(1.0))
    n2 = jnp.where(s.in_medium, jnp.float32(1.0), ior)
    ior_ratio = n1 / n2
    cos_i = -dot(s.direction, N)
    cos_theta2 = jnp.float32(1.0) - ior_ratio * ior_ratio * (
        jnp.float32(1.0) - cos_i * cos_i
    )
    can_refract = cos_theta2 > 0
    a_ = n1 - n2
    b_ = n1 + n2
    r0 = (a_ * a_) / (b_ * b_)
    c_ = jnp.float32(1.0) - cos_i
    fresnel = r0 + (jnp.float32(1.0) - r0) * (c_ * c_ * c_ * c_ * c_)
    seed, r_fr = rng.next_f32_masked(seed, m_diel & can_refract)
    must_refract = m_diel & can_refract & (r_fr > sg(fresnel))
    # d(sqrt)/dx = inf at x == 0, and cos_theta2 is EXACTLY 0 on
    # exactly-grazing lanes (cos_i == 0 with the substituted ior = 1 makes
    # cos_theta2 = cos_i^2; measured at 128x8 on the box scene).  Under
    # lax.scan/fori_loop reverse-mode the carry cotangents are
    # MATERIALIZED zeros (not symbolic), so the masked where no longer
    # prunes the product and 0 * inf = NaN poisons the camera gradients —
    # even though the direct (unrolled) backward of the same wave is
    # finite.  refract_dir is only consumed where must_refract
    # (cos_theta2 > 0), so flooring the sqrt argument at 1e-12 is
    # primal-identical outside exactly-critical-angle f32 paths.
    refract_dir = (
        ior_ratio[:, None] * s.direction
        + (ior_ratio * cos_i
           - jnp.sqrt(jnp.maximum(jnp.abs(cos_theta2),
                                  jnp.float32(1e-12))))[:, None] * N
    )
    r_out = jnp.where(
        m_diel[:, None],
        jnp.where(must_refract[:, None], refract_dir, refl_dir),
        r_out,
    )
    new_trans = jnp.where(m_diel[:, None], spec_trans, new_trans)
    new_last_spec = jnp.where(m_diel, True, new_last_spec)
    new_in_medium = jnp.where(must_refract, ~s.in_medium, new_in_medium)

    # diffuse: cosine bounce + NEE + RR
    seed, cos_dir = sampling.cosine_hemisphere(seed, N, m_diff)
    r_out = jnp.where(m_diff[:, None], cos_dir, r_out)
    cos_theta = dot(N, cos_dir)
    brdf = albedo * F32_INV_PI

    if cfg.num_lights > 0:
        seed, energy = _next_event(
            scene, cfg, seed, m_diff, I, N, brdf, s.transmission, energy,
        )

    # Russian roulette (renderer.cpp:446-454); termination detached.
    # cfg.rr=False disables the kill AND the 1/p compensation (the RNG
    # draw is still consumed so all other streams are unchanged): used by
    # the tight FD gradient gate, where RR's detached decision boundary is
    # the one discrete term that makes finite differences of the estimator
    # diverge from its AD derivative (VERDICT r4 item 5).
    p = jnp.clip(jnp.max(s.transmission, axis=1), 0.0, 1.0)
    seed, r_rr = rng.next_f32_masked(seed, m_diff)
    rr_kill = (m_diff & (sg(p) < r_rr) if cfg.rr
               else jnp.zeros_like(m_diff))
    alive = alive & ~rr_kill
    m_diff_live = m_diff & ~rr_kill
    # diff_trans is only consumed under m_diff_live, but non-diffuse lanes
    # have cos_dir = 0 -> diffuse_pdf = 0 -> inv_pdf = inf, and the masked
    # where's backward turns 0*inf into NaN cotangents that scatter-add
    # into the SPECULAR/DIELECTRIC materials' albedo rows (measured NaN AD
    # on the indoor scene, round 5).  Substituting pdf 1 on non-diffuse
    # lanes is primal-identical and keeps every cotangent finite.
    diffuse_pdf = jnp.where(m_diff, cos_theta * F32_INV_PI, jnp.float32(1.0))
    inv_pdf = jnp.float32(1.0) / diffuse_pdf
    # p can be EXACTLY 0 on still-alive diffuse lanes (albedos with zero
    # channels zero the transmission product: e.g. a red wall then a green
    # wall), making rr_scale = inf and diff_trans = 0*inf = NaN in the
    # rr_kill-masked branch — another 0*NaN cotangent poison (the wave-2
    # NaN lanes measured in round 5 had transmission == 0).  Such lanes
    # are RR-killed with certainty (sg(0) < r_rr), so clamping the
    # detached divisor is primal-identical outside f32-denormal paths.
    rr_scale = jnp.float32(1.0) / sg(
        jnp.where(m_diff, jnp.maximum(p, jnp.float32(1e-12)),
                  jnp.float32(1.0))) if cfg.rr else jnp.ones_like(p)
    diff_trans = (
        s.transmission
        * cos_theta[:, None] * inv_pdf[:, None] * brdf
        * medium_scale * rr_scale[:, None]
    )
    new_trans = jnp.where(m_diff_live[:, None], diff_trans, new_trans)
    new_last_spec = jnp.where(m_diff_live, False, new_last_spec)

    origin = jnp.where(alive[:, None], I + F32_EPSILON * r_out, s.origin)
    direction = jnp.where(alive[:, None], r_out, s.direction)

    return PathState(
        origin=origin,
        direction=direction,
        seed=seed,
        transmission=jnp.where(alive[:, None], new_trans, s.transmission),
        energy=energy,
        last_specular=jnp.where(alive, new_last_spec, s.last_specular),
        in_medium=jnp.where(alive, new_in_medium, s.in_medium),
        alive=alive,
        pixel=s.pixel,
    )


def _reintersect(origin, direction, v0, v1, v2):
    """Differentiable Möller–Trumbore at a fixed triangle (no tests)."""
    e1 = v1 - v0
    e2 = v2 - v0
    h = _cross(direction, e2)
    a = dot(e1, h)
    # Miss lanes re-intersect slot 0 with an unrelated ray that can be
    # exactly parallel to it (a == 0, measured at 128x8 on the box scene):
    # f = inf makes every downstream partial inf, and the where(found,...)
    # substitutions only zero the COTANGENT — 0 * inf = NaN still lands in
    # the camera gradients.  Lanes the traversal reports found have
    # |a| >= 1e-5 (the kernel/oracle MT epsilon, _mt8 / cpu_renderer.py:63),
    # so clamping |a| below 1e-12 is primal-identical on every consumed
    # lane and keeps all partials finite.
    a = jnp.where(jnp.abs(a) < jnp.float32(1e-12),
                  jnp.where(a < 0, jnp.float32(-1e-12), jnp.float32(1e-12)),
                  a)
    f = jnp.float32(1.0) / a
    srel = origin - v0
    u = f * dot(srel, h)
    q = _cross(srel, e1)
    v = f * dot(direction, q)
    t = f * dot(e2, q)
    return t, u, v


def _cross(a, b):
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def _next_event(scene, cfg, seed, m_diff, I, N, brdf, transmission, energy):
    """NEE: sample one light instance + surface point, build shadow rays,
    resolve occlusion (ray_shade.comp:125-174 + ray_connect.comp:178-212).

    RNG draw order per diffuse lane: light pick, u, v, triangle id — matching
    Scene::sampleLights + Instance::samplePoint (scene.h:53, bvh.cpp:533-552)."""
    sg = jax.lax.stop_gradient
    seed, li_raw = rng.next_u32_masked(seed, m_diff)
    li = (li_raw % jnp.uint32(cfg.num_lights)).astype(jnp.int32)
    light_inst = jnp.take(scene.light_inst, li)
    seed, su = rng.next_f32_masked(seed, m_diff)
    seed, sv_raw = rng.next_f32_masked(seed, m_diff)
    sv = sv_raw * (jnp.float32(1.0) - su)
    seed, ti_raw = rng.next_u32_masked(seed, m_diff)
    tri_local = (
        ti_raw % jnp.take(scene.inst_tri_count, light_inst).astype(jnp.uint32)
    ).astype(jnp.int32)
    tri_idx = jnp.take(scene.inst_tri_offset, light_inst) + tri_local

    w = jnp.float32(1.0) - su - sv
    p_pos = (
        su[:, None] * jnp.take(scene.samp_v0, tri_idx, axis=0)
        + sv[:, None] * jnp.take(scene.samp_v2, tri_idx, axis=0)
        + w[:, None] * jnp.take(scene.samp_v1, tri_idx, axis=0)
    )
    p_raw = (
        su[:, None] * jnp.take(scene.samp_n0, tri_idx, axis=0)
        + sv[:, None] * jnp.take(scene.samp_n2, tri_idx, axis=0)
        + w[:, None] * jnp.take(scene.samp_n1, tri_idx, axis=0)
    )
    p_nrm = normalize(p_raw)
    IL = p_pos - I
    L = normalize(IL)
    SO = I + F32_EPSILON * L
    sr_depth = jnp.sqrt(dot(IL, IL)) - jnp.float32(2.0) * F32_EPSILON
    falloff = jnp.float32(1.0) / dot(IL, IL)
    cos_o = dot(N, L)
    cos_li = dot(p_nrm, -L)
    nee_ok = m_diff & (cos_o > 0) & (cos_li > 0)

    # CONNECT: any-hit occlusion traversal, detached.
    occ_hit = _dispatch_traverse(
        jax.tree.map(sg, scene.trace), sg(SO), sg(L), sg(sr_depth),
        nee_ok, any_hit=True,
    )
    unoccluded = nee_ok & (occ_hit.prim < 0)

    area = jnp.take(scene.inst_area, light_inst)
    SA = cos_li * area * falloff
    lmat = jnp.take(scene.inst_material, light_inst)
    l_emit = _emittance(scene, lmat)
    Ld = l_emit * SA[:, None] * brdf * cos_o[:, None] * jnp.float32(cfg.num_lights)
    energy = jnp.where(unoccluded[:, None], energy + transmission * Ld, energy)
    return seed, energy


# --------------------------------------------------------------------------
# Sample / frame loops (replaces the host wave loop renderer.cpp:1030-1106)
# --------------------------------------------------------------------------

def _bounce_loop(scene: RenderScene, cfg: RenderConfig, state: PathState
                 ) -> PathState:
    """The on-device wave loop (shared by fresh samples and deferred-path
    continuation): bounce until every path terminates, the wave cap, or the
    static bounce budget."""

    def wave(i, s):
        if cfg.compact:
            if cfg.compact_every > 1:
                s = jax.lax.cond(
                    i % cfg.compact_every == 0, compact_paths,
                    lambda x: x, s)
            else:
                s = compact_paths(s)
        return bounce_step(scene, cfg, s)

    if cfg.remat:
        # Rematerialize per wave: reverse-mode memory drops from
        # O(max_bounces * state) residuals to O(state) per wave at the cost
        # of recomputing each wave's forward in the backward sweep
        # (jax.checkpoint; SURVEY.md HBM guidance).
        wave = jax.checkpoint(wave)

    if cfg.max_bounces is None:
        def cond(carry):
            i, s = carry
            return jnp.any(s.alive) & (i < cfg.wave_limit)

        def body(carry):
            i, s = carry
            return i + 1, wave(i, s)

        _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    else:
        def body(i, s):
            return wave(i, s)

        state = jax.lax.fori_loop(0, cfg.max_bounces, body, state)
        # Paths still alive at the cap contribute nothing further unless
        # the caller carries them across frames (FrameCarry deferral).
    return state


def _bounce_loop_ladder(scene: RenderScene, cfg: RenderConfig,
                        state: PathState):
    """Width-ladder wave loop: run at full lane width only while more than
    1/cfg.ladder_shrink of lanes are alive, then stable-compact, retire
    the dead suffix, and continue the loop on the live prefix at
    1/cfg.ladder_shrink the width (repeated cfg.ladder times, so rung k
    runs at width n/ladder_shrink**k).  Occupancy decays to <1% by wave
    ~20 on the indoor
    scene while every width-proportional per-wave cost (shade, NEE,
    RNG, compaction) still pays full lane width — the ladder is the
    dense-lane stand-in for the reference's shrinking atomic work queues
    (renderer.cpp:1070-1105) at the *dispatch width* level, complementing
    the traversal's dead-block exit.

    Per-lane results are bit-identical to the plain compacted loop: each
    lane sees the same masked op sequence and carries its own RNG
    stream; only the set of lanes co-resident in a dispatch changes.
    Returns (seed, energy) in PIXEL order — each lane scatters home
    exactly once across the retirement banks."""
    assert cfg.ladder_shrink >= 2, \
        "ladder_shrink=1 makes every rung a no-op (m //= 1)"
    n = state.seed.shape[0]

    def wave(i, s):
        if cfg.compact:
            if cfg.compact_every > 1:
                s = jax.lax.cond(
                    i % cfg.compact_every == 0, compact_paths,
                    lambda x: x, s)
            else:
                s = compact_paths(s)
        return bounce_step(scene, cfg, s)

    def run(i0, s, thresh):
        def cond(carry):
            i, s2 = carry
            ok = jnp.any(s2.alive) & (i < cfg.wave_limit)
            if thresh is not None:
                ok = ok & (jnp.sum(s2.alive) > thresh)
            return ok

        def body(carry):
            i, s2 = carry
            return i + 1, wave(i, s2)

        return jax.lax.while_loop(cond, body, (i0, s))

    widths = []
    m = n
    for _ in range(cfg.ladder):
        m //= cfg.ladder_shrink
        if m >= BLOCK_RAYS:  # no narrower than one traversal block
            widths.append(m)

    banked = []  # (pixel, seed, energy) of lanes retired from the loop
    i = jnp.int32(0)
    for m in widths:
        i, state = run(i, state, jnp.int32(m))
        state = compact_paths(state)
        banked.append((state.pixel[m:], state.seed[m:],
                       state.energy[m:]))
        state = PathState(*(x[:m] for x in state))
    i, state = run(i, state, None)
    banked.append((state.pixel, state.seed, state.energy))

    seed_out = jnp.zeros(n, jnp.uint32)
    energy_out = jnp.zeros((n, 3), jnp.float32)
    for p, sd, e in banked:
        seed_out = seed_out.at[p].set(sd, unique_indices=True)
        energy_out = energy_out.at[p].set(e, unique_indices=True)
    return seed_out, energy_out


def render_sample(scene: RenderScene, cfg: RenderConfig, vp: ViewPlane,
                  seed, px, py, pixel_ids=None):
    """One sample for every pixel lane: raygen + full bounce loop on device.

    ``pixel_ids`` (optional [N] int32 permutation) maps lane i to a pixel
    other than i (cfg.pixel_order="morton"); seed/energy are then returned
    in PIXEL order via the same inverse scatter compaction uses."""
    seed, origin, direction = ray_generation(cfg, vp, seed, px, py)
    n = seed.shape[0]
    state = PathState(
        origin=origin,
        direction=direction,
        seed=seed,
        transmission=jnp.ones((n, 3), jnp.float32),
        energy=jnp.zeros((n, 3), jnp.float32),
        last_specular=jnp.ones(n, bool),
        in_medium=jnp.zeros(n, bool),
        alive=jnp.ones(n, bool),
        pixel=(jnp.arange(n, dtype=jnp.int32) if pixel_ids is None
               else pixel_ids),
    )
    if cfg.ladder > 0 and cfg.max_bounces is None:
        return _bounce_loop_ladder(scene, cfg, state)
    state = _bounce_loop(scene, cfg, state)

    if cfg.compact or pixel_ids is not None:
        # Restore pixel order for the per-pixel accumulator and seed
        # streams.  state.pixel is a permutation, so its inverse is one
        # scatter (no argsort).
        n_ = state.pixel.shape[0]
        order = jnp.zeros(n_, jnp.int32).at[state.pixel].set(
            jnp.arange(n_, dtype=jnp.int32), unique_indices=True)
        return (
            jnp.take(state.seed, order),
            jnp.take(state.energy, order, axis=0),
        )
    return state.seed, state.energy


def render_frame(scene: RenderScene, cfg: RenderConfig, cam: CameraParams,
                 total_samples: jnp.ndarray):
    """One frame of cfg.spp samples per pixel. Returns radiance sums
    [H, W, 3] (divide by the accumulated sample count outside — the
    wavefront_finalize analog)."""
    n = cfg.width * cfg.height
    lane = jnp.arange(n, dtype=jnp.uint32)
    seed0 = rng.pixel_seed(lane, total_samples)
    acc, _ = _render_samples_from_seed(scene, cfg, cam, seed0)
    return acc


def lane_pixel_perm(cfg: RenderConfig):
    """Static lane->pixel permutation for cfg.pixel_order, or None for the
    identity (native row-major).  "morton" interleaves the x/y bits of the
    pixel coordinate (stable-argsorted, so any W/H works)."""
    if cfg.pixel_order == "native":
        return None
    if cfg.pixel_order != "morton":
        raise ValueError(f"unknown pixel_order {cfg.pixel_order!r}")
    import numpy as np

    n = cfg.width * cfg.height
    px = np.arange(n, dtype=np.uint64) % cfg.width
    py = np.arange(n, dtype=np.uint64) // cfg.width
    code = np.zeros(n, np.uint64)
    for b in range(max(cfg.width, cfg.height).bit_length()):
        code |= ((px >> b) & 1) << (2 * b)
        code |= ((py >> b) & 1) << (2 * b + 1)
    return jnp.asarray(np.argsort(code, kind="stable").astype(np.int32))


def _render_samples_from_seed(scene, cfg: RenderConfig, cam, seed0):
    vp = view_plane_jnp(cam, cfg.width, cfg.height)
    n = cfg.width * cfg.height
    perm = lane_pixel_perm(cfg)
    lane_pixel = jnp.arange(n, dtype=jnp.uint32) if perm is None \
        else perm.astype(jnp.uint32)
    px = (lane_pixel % jnp.uint32(cfg.width)).astype(jnp.int32)
    py = (lane_pixel // jnp.uint32(cfg.width)).astype(jnp.int32)

    def body(_, carry):
        # carry is in PIXEL order (seed streams and the accumulator are
        # per-pixel regardless of the lane mapping).
        seed, acc = carry
        seed_lane = seed if perm is None else jnp.take(seed, perm)
        seed, energy = render_sample(
            scene, cfg, vp, seed_lane, px, py,
            pixel_ids=None if perm is None else perm)
        return seed, acc + energy

    seed, acc = jax.lax.fori_loop(
        0, cfg.spp, body, (seed0, jnp.zeros((n, 3), jnp.float32))
    )
    return acc.reshape(cfg.height, cfg.width, 3), seed


@partial(jax.jit, static_argnums=(1,))
def render_frame_seeded(scene: RenderScene, cfg: RenderConfig,
                        cam: CameraParams, seed0: jnp.ndarray):
    """Render cfg.spp samples continuing the given per-pixel seed streams;
    returns (radiance_sums [H,W,3], final seeds).  Consecutive calls
    continue the same RNG streams, so splitting a sample budget over
    several calls gives the image of a single call bit for bit."""
    return _render_samples_from_seed(scene, cfg, cam, seed0)


def initial_seeds(cfg: RenderConfig, total_samples) -> jnp.ndarray:
    n = cfg.width * cfg.height
    return rng.pixel_seed(jnp.arange(n, dtype=jnp.uint32), total_samples)


# --------------------------------------------------------------------------
# Cross-frame deferral (renderer.cpp:27-29, 1101-1104): paths still alive at
# the wave cap are NOT dropped — they persist in a FrameCarry and resume in
# the next frame, so the wave-cap estimator bias is exactly zero.  Each
# deferred path continues with its own carried seed stream, so its radiance
# is bit-identical to what an uncapped single-frame render would produce —
# just banked across frames.
# --------------------------------------------------------------------------

class FrameCarry(NamedTuple):
    """Persistent cross-frame wavefront state: a fixed N-lane pool of
    deferred paths (.alive marks occupancy; .pixel routes banked energy)
    and an overflow counter (the fixed-size analog of the reference's elastic
    shadow-buffer growth, SURVEY.md §5.3: capacity is static, overflow is
    counted and dropped, never reallocated)."""

    deferred: PathState
    dropped: jnp.ndarray  # [] int32


def empty_frame_carry(cfg: RenderConfig) -> FrameCarry:
    n = cfg.width * cfg.height
    z3 = jnp.zeros((n, 3), jnp.float32)
    return FrameCarry(
        deferred=PathState(
            origin=z3, direction=z3,
            seed=jnp.zeros(n, jnp.uint32),
            transmission=z3, energy=z3,
            last_specular=jnp.zeros(n, bool),
            in_medium=jnp.zeros(n, bool),
            alive=jnp.zeros(n, bool),
            pixel=jnp.zeros(n, jnp.int32),
        ),
        dropped=jnp.int32(0),
    )


def _merge_deferred(d: PathState, s: PathState, dropped):
    """Append s's live lanes after d's live prefix; overflow beyond the
    fixed pool is counted into ``dropped``.

    INVARIANT: ``d`` is already live-prefix-compacted — empty_frame_carry
    starts compact, this merge preserves compactness (it appends s's
    compacted live prefix right after d's), and _continue_deferred
    re-compacts after draining.  Skipping the pool-side compact halves
    the per-sample merge cost (the dominant term in the round-3 deferral
    A/B: defer32 1585 ms vs plain32 1179 ms was ~2 compact_paths per
    SAMPLE; VERDICT r3 item 3's 'once-per-frame merge' equivalent)."""
    n = d.alive.shape[0]
    s = compact_paths(s)
    m = jnp.sum(d.alive.astype(jnp.int32))
    k = jnp.sum(s.alive.astype(jnp.int32))
    idx = jnp.arange(n, dtype=jnp.int32)
    src = jnp.clip(idx - m, 0, n - 1)
    take_new = (idx >= m) & (idx < m + k)

    def mix(df, sf):
        sg = jnp.take(sf, src, axis=0)
        mask = take_new if df.ndim == 1 else take_new[:, None]
        return jnp.where(mask, sg, df)

    merged = jax.tree.map(mix, d, s)
    dropped = dropped + jnp.maximum(m + k - n, 0)
    return merged, dropped


def _continue_deferred(scene, cfg: RenderConfig, carry: FrameCarry):
    """Run the wave loop over the deferred pool; bank newly produced energy
    by pixel; survivors stay deferred (energy re-zeroed)."""
    n = carry.deferred.alive.shape[0]
    drain_cfg = cfg._replace(
        wave_limit=max(cfg.wave_limit, cfg.defer_drain),
        compact=True, compact_every=min(cfg.compact_every, 4)
        if cfg.compact else 4,
    )
    d = _bounce_loop(scene, drain_cfg, carry.deferred)
    add = jnp.zeros((n, 3), jnp.float32).at[d.pixel].add(d.energy)
    d = d._replace(energy=jnp.zeros_like(d.energy))
    # restore the _merge_deferred pool-compactness invariant (the drain's
    # final waves may kill lanes after the last in-loop compaction)
    return add, carry._replace(deferred=compact_paths(d))


def render_sample_deferring(scene: RenderScene, cfg: RenderConfig,
                            vp: ViewPlane, seed, px, py):
    """render_sample variant that returns the capped-out survivors instead
    of dropping them: (next_seed, energy[N,3] in pixel order, survivors).
    The survivors' partial energy is banked into the returned energy and
    zeroed in the survivor state (their future bounces bank next frame)."""
    seed, origin, direction = ray_generation(cfg, vp, seed, px, py)
    n = seed.shape[0]
    state = PathState(
        origin=origin, direction=direction, seed=seed,
        transmission=jnp.ones((n, 3), jnp.float32),
        energy=jnp.zeros((n, 3), jnp.float32),
        last_specular=jnp.ones(n, bool),
        in_medium=jnp.zeros(n, bool),
        alive=jnp.ones(n, bool),
        pixel=jnp.arange(n, dtype=jnp.int32),
    )
    state = _bounce_loop(scene, cfg, state)
    # Bank ALL energy (pixel-order scatter handles compaction permutations
    # for free), then zero it in the surviving paths.
    energy = jnp.zeros((n, 3), jnp.float32).at[state.pixel].add(state.energy)
    seed_out = jnp.zeros(n, jnp.uint32).at[state.pixel].set(state.seed)
    survivors = state._replace(energy=jnp.zeros_like(state.energy))
    return seed_out, energy, survivors


def render_frame_carry(scene: RenderScene, cfg: RenderConfig,
                       cam: CameraParams, seed0: jnp.ndarray,
                       carry: FrameCarry):
    """One frame with cross-frame deferral: continue last frame's deferred
    paths, render cfg.spp fresh samples, defer this frame's capped-out
    paths.  Returns (radiance_sums [H,W,3], next seeds, next carry)."""
    vp = view_plane_jnp(cam, cfg.width, cfg.height)
    n = cfg.width * cfg.height
    lane = jnp.arange(n, dtype=jnp.uint32)
    px = (lane % jnp.uint32(cfg.width)).astype(jnp.int32)
    py = (lane // jnp.uint32(cfg.width)).astype(jnp.int32)

    acc0, carry = _continue_deferred(scene, cfg, carry)

    def body(_, c):
        seed, acc, carry = c
        seed, energy, surv = render_sample_deferring(
            scene, cfg, vp, seed, px, py)
        deferred, dropped = _merge_deferred(
            carry.deferred, surv, carry.dropped)
        return seed, acc + energy, FrameCarry(deferred, dropped)

    seed, acc, carry = jax.lax.fori_loop(
        0, cfg.spp, body, (seed0, acc0, carry))
    return acc.reshape(cfg.height, cfg.width, 3), seed, carry


@partial(jax.jit, static_argnums=(1,))
def render_frame_carry_jit(scene: RenderScene, cfg: RenderConfig,
                           cam: CameraParams, seed0: jnp.ndarray,
                           carry: FrameCarry):
    return render_frame_carry(scene, cfg, cam, seed0, carry)


@partial(jax.jit, static_argnums=(1,))
def render_frame_jit(scene: RenderScene, cfg: RenderConfig, cam: CameraParams,
                     total_samples: jnp.ndarray):
    return render_frame(scene, cfg, cam, total_samples)


def render_sample_instrumented(scene: RenderScene, cfg: RenderConfig,
                               vp: ViewPlane, seed, px, py):
    """render_sample variant that also reports wavefront statistics
    (SURVEY.md §5.5: waves/sample, queue occupancy, deferral):
    returns (seed, energy, stats) with stats = {waves, lane_steps,
    deferred} — lane_steps is the occupancy integral (sum of live lanes
    over waves) and deferred counts paths still alive at the wave cap (the
    analog of the reference's cross-frame deferred batches,
    renderer.cpp:1101-1104)."""
    seed, origin, direction = ray_generation(cfg, vp, seed, px, py)
    n = seed.shape[0]
    state = PathState(
        origin=origin, direction=direction, seed=seed,
        transmission=jnp.ones((n, 3), jnp.float32),
        energy=jnp.zeros((n, 3), jnp.float32),
        last_specular=jnp.ones(n, bool), in_medium=jnp.zeros(n, bool),
        alive=jnp.ones(n, bool), pixel=jnp.arange(n, dtype=jnp.int32),
    )

    limit = cfg.wave_limit if cfg.max_bounces is None else cfg.max_bounces

    def cond(carry):
        i, s, _ = carry
        return jnp.any(s.alive) & (i < limit)

    def body(carry):
        i, s, lane_steps = carry
        lane_steps = lane_steps + jnp.sum(s.alive.astype(jnp.int32))
        if cfg.compact:
            s = compact_paths(s)
        return i + 1, bounce_step(scene, cfg, s), lane_steps

    waves, state, lane_steps = jax.lax.while_loop(
        cond, body, (jnp.int32(0), state, jnp.int32(0))
    )
    deferred = jnp.sum(state.alive.astype(jnp.int32))
    if cfg.compact:
        n_ = state.pixel.shape[0]
        order = jnp.zeros(n_, jnp.int32).at[state.pixel].set(
            jnp.arange(n_, dtype=jnp.int32), unique_indices=True)
        seed_out = jnp.take(state.seed, order)
        energy = jnp.take(state.energy, order, axis=0)
    else:
        seed_out, energy = state.seed, state.energy
    stats = dict(waves=waves, lane_steps=lane_steps, deferred=deferred)
    return seed_out, energy, stats


@partial(jax.jit, static_argnums=(1,))
def render_frame_instrumented(scene: RenderScene, cfg: RenderConfig,
                              cam: CameraParams, total_samples: jnp.ndarray):
    """One frame + aggregated wavefront stats dict."""
    vp = view_plane_jnp(cam, cfg.width, cfg.height)
    n = cfg.width * cfg.height
    lane = jnp.arange(n, dtype=jnp.uint32)
    px = (lane % jnp.uint32(cfg.width)).astype(jnp.int32)
    py = (lane // jnp.uint32(cfg.width)).astype(jnp.int32)
    seed0 = rng.pixel_seed(lane, total_samples)

    def body(_, carry):
        seed, acc, waves, steps, deferred = carry
        seed, energy, st = render_sample_instrumented(scene, cfg, vp, seed, px, py)
        return (seed, acc + energy, waves + st["waves"],
                steps + st["lane_steps"], deferred + st["deferred"])

    _, acc, waves, steps, deferred = jax.lax.fori_loop(
        0, cfg.spp, body,
        (seed0, jnp.zeros((n, 3), jnp.float32), jnp.int32(0), jnp.int32(0),
         jnp.int32(0)),
    )
    stats = dict(
        waves=waves, lane_steps=steps, deferred=deferred,
        occupancy=steps.astype(jnp.float32)
        / jnp.maximum(waves.astype(jnp.float32) * n, 1.0),
    )
    return acc.reshape(cfg.height, cfg.width, 3), stats
