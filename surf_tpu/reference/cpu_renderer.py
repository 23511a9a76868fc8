"""Vectorized NumPy oracle renderer.

The trusted host-side implementation of the full path-tracing estimator
(diffuse / specular / dielectric lobes, NEE, Russian roulette, thin-lens
camera) with per-pixel sequential RNG streams identical to the reference CPU
renderer (/root/reference/sources/renderer.cpp:148-464): lanes that do not
take a branch do not consume randoms, so each pixel's stream is bit-identical
to the ScalarRenderer transcription (validated on tiny images) while running
~1000x faster via lane vectorization.  This is the golden image source for
the TPU wavefront parity tests (SURVEY.md §4).

Intersection is brute force over all world triangles, chunked — deliberately
independent of the BVH so it also serves as the traversal oracle.
"""

from __future__ import annotations

import numpy as np

from ..scene.camera import Camera
from ..scene.compile import HostCompiled
from . import rng_np as R

F32_EPSILON = np.float32(1e-5)
F32_FAR_AWAY = np.float32(1e30)
F32_PI = np.float32(3.14159265358979323846264)
F32_INV_PI = np.float32(0.31830988618379067153777)
F32_2PI = np.float32(6.28318530717958647692528)
WORLD_UP = np.array([0, 1, 0], np.float32)
WORLD_RIGHT = np.array([1, 0, 0], np.float32)


def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _normalize(v):
    return v / np.sqrt(_dot(v, v))[..., None]


class OracleRenderer:
    def __init__(self, host: HostCompiled, camera: Camera, tri_chunk: int = 2048):
        self.h = host
        self.cam = camera
        self.tri_chunk = tri_chunk
        self.first_pixel, self.u_vec, self.v_vec = camera.view_plane()
        self._e1 = (host.samp_v1 - host.samp_v0).astype(np.float32)
        self._e2 = (host.samp_v2 - host.samp_v0).astype(np.float32)

    # ------------------------------------------------------------------ geo
    def _mt_chunk(self, o, d, v0, e1, e2, t_bound):
        """Möller–Trumbore, lanes [N] x chunk [c] -> [N, c] (mesh.cpp:23-62)."""
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            h = np.cross(d[:, None, :], e2[None])
            a = _dot(e1[None], h)
            f = np.float32(1.0) / a
            s = o[:, None, :] - v0[None]
            u = f * _dot(s, h)
            q = np.cross(s, e1[None])
            v = f * _dot(d[:, None, :], q)
            t = f * _dot(e2[None], q)
            ok = (
                (np.abs(a) >= F32_EPSILON)
                & (u >= 0.0) & (u <= 1.0)
                & (v >= 0.0) & (u + v <= 1.0)
                & (t >= F32_EPSILON) & (t < t_bound[:, None])
            )
        return ok, t, u, v

    def _closest(self, o, d, t_max, active):
        n = len(o)
        best_t = t_max.astype(np.float32).copy()
        best_prim = np.full(n, -1, np.int64)
        best_u = np.zeros(n, np.float32)
        best_v = np.zeros(n, np.float32)
        T = len(self.h.samp_v0)
        act = np.where(active)[0]
        if len(act) == 0:
            return best_prim, best_t, best_u, best_v
        for start in range(0, T, self.tri_chunk):
            end = min(start + self.tri_chunk, T)
            ok, t, u, v = self._mt_chunk(
                o[act], d[act],
                self.h.samp_v0[start:end], self._e1[start:end], self._e2[start:end],
                best_t[act],
            )
            t = np.where(ok, t, np.inf)
            j = np.argmin(t, axis=1)
            rows = np.arange(len(act))
            tj = t[rows, j]
            upd = tj < best_t[act]
            lanes = act[upd]
            best_t[lanes] = tj[upd].astype(np.float32)
            best_prim[lanes] = start + j[upd]
            best_u[lanes] = u[rows, j][upd]
            best_v[lanes] = v[rows, j][upd]
        return best_prim, best_t, best_u, best_v

    def _occluded(self, o, d, t_max, active):
        n = len(o)
        occ = np.zeros(n, bool)
        T = len(self.h.samp_v0)
        for start in range(0, T, self.tri_chunk):
            act = np.where(active & ~occ)[0]
            if len(act) == 0:
                break
            end = min(start + self.tri_chunk, T)
            ok, _, _, _ = self._mt_chunk(
                o[act], d[act],
                self.h.samp_v0[start:end], self._e1[start:end], self._e2[start:end],
                t_max[act],
            )
            occ[act] |= ok.any(axis=1)
        return occ

    # ----------------------------------------------------------------- rng
    def _cosine_hemisphere(self, seed, normal, active):
        """Masked-rejection port of surf_math.cpp:116-134."""
        n = len(seed)
        out = np.zeros((n, 3), np.float32)
        need = active.copy()
        while need.any():
            seed, r0 = R.next_f32_masked(seed, need)
            seed, r1 = R.next_f32_masked(seed, need)
            r = np.sqrt(r0)
            theta = F32_2PI * r1
            d = np.stack(
                [r * np.cos(theta), r * np.sin(theta), np.sqrt(np.float32(1.0) - r0)],
                axis=-1,
            ).astype(np.float32)
            x_max = np.float32(1.0) - F32_EPSILON
            tmp = np.where(np.abs(normal[:, 0:1]) > x_max, WORLD_UP, WORLD_RIGHT)
            b = _normalize(np.cross(normal, tmp)).astype(np.float32)
            t = np.cross(b, normal).astype(np.float32)
            cand = (d[:, 0:1] * t + d[:, 1:2] * b + d[:, 2:3] * normal).astype(np.float32)
            out = np.where(need[:, None], cand, out)
            need = need & (_dot(out, normal) == np.float32(0.0))
        return seed, out

    def _unit_disk(self, seed, active):
        n = len(seed)
        su = np.zeros(n, np.float32)
        sv = np.zeros(n, np.float32)
        need = active.copy()
        while need.any():
            seed, u = R.next_f32_masked(seed, need)
            seed, v = R.next_f32_masked(seed, need)
            u = (u * np.float32(2.0) - np.float32(1.0)).astype(np.float32)
            v = (v * np.float32(2.0) - np.float32(1.0)).astype(np.float32)
            su = np.where(need, u, su)
            sv = np.where(need, v, sv)
            need = need & (su * su + sv * sv > np.float32(1.0))
        return seed, su, sv

    # -------------------------------------------------------------- camera
    def _primary_rays(self, seed, px, py):
        seed, jx = R.next_f32_masked(seed, np.ones(len(seed), bool))
        seed, jy = R.next_f32_masked(seed, np.ones(len(seed), bool))
        jx = (jx - np.float32(0.5)).astype(np.float32)
        jy = (jy - np.float32(0.5)).astype(np.float32)
        fx = px.astype(np.float32) + jx
        fy = py.astype(np.float32) + jy
        u = (fx * np.float32(1.0 / self.cam.screen_width)).astype(np.float32)
        v = (fy * np.float32(1.0 / self.cam.screen_height)).astype(np.float32)
        if self.cam.defocus_angle == 0.0:
            origin = np.broadcast_to(self.cam.position, (len(seed), 3)).astype(np.float32)
        else:
            radius = np.float32(
                self.cam.focal_length
                * np.tan(
                    np.float32(self.cam.defocus_angle / 2.0)
                    * F32_PI * np.float32(0.005555555555555)
                )
            )
            du = self.cam.right() * radius
            dv = (-1.0 * self.cam.up * radius).astype(np.float32)
            seed, su, sv = self._unit_disk(seed, np.ones(len(seed), bool))
            origin = (
                self.cam.position + su[:, None] * du + sv[:, None] * dv
            ).astype(np.float32)
        plane = (
            self.first_pixel
            + u[:, None] * self.u_vec
            + v[:, None] * self.v_vec
        ).astype(np.float32)
        direction = _normalize(plane - origin).astype(np.float32)
        return seed, origin, direction

    def _background(self, d):
        bg = self.h.scene.background
        if bg.type == 0:
            return np.broadcast_to(bg.color, d.shape).astype(np.float32)
        alpha = (np.float32(0.5) * (np.float32(1.0) + d[:, 1])).astype(np.float32)
        return (
            alpha[:, None] * bg.gradient_b
            + (np.float32(1.0) - alpha)[:, None] * bg.gradient_a
        ).astype(np.float32)

    # --------------------------------------------------------------- trace
    def _trace(self, seed, origin, direction, max_iters=4096):
        """Vectorized iterative megakernel loop (renderer.cpp:331-463)."""
        h = self.h
        mats = h.materials
        n = len(origin)
        energy = np.zeros((n, 3), np.float32)
        transmission = np.ones((n, 3), np.float32)
        last_specular = np.ones(n, bool)
        in_medium = np.zeros(n, bool)
        alive = np.ones(n, bool)
        light_list = np.asarray(h.scene.light_indices, np.int64)
        light_count = len(light_list)
        inst_area = np.array([i.area for i in h.scene.instances], np.float32)

        for _ in range(max_iters):
            if not alive.any():
                break
            prim, t, u, v = self._closest(
                origin, direction, np.full(n, F32_FAR_AWAY, np.float32), alive
            )
            miss = alive & (prim < 0)
            energy[miss] += transmission[miss] * self._background(direction[miss])
            alive = alive & ~miss

            prim_safe = np.maximum(prim, 0)
            inst = h.tri_inst[prim_safe].astype(np.int64)
            mat = h.inst_material[inst].astype(np.int64)

            hit_light = alive & mats.is_light[mat]
            lit = hit_light & last_specular
            emit = (
                mats.emission_strength[mat, None] * mats.emission_color[mat]
            ).astype(np.float32)
            energy[lit] += transmission[lit] * emit[lit]
            alive = alive & ~hit_light

            medium_scale = np.where(
                in_medium[:, None],
                np.exp(mats.absorption[mat] * -t[:, None]).astype(np.float32),
                np.float32(1.0),
            ).astype(np.float32)

            I = (origin + t[:, None] * direction).astype(np.float32)
            N = (
                u[:, None] * h.samp_n0[prim_safe]
                + v[:, None] * h.samp_n2[prim_safe]
                + (np.float32(1.0) - u - v)[:, None] * h.samp_n1[prim_safe]
            ).astype(np.float32)
            N = _normalize(N).astype(np.float32)

            seed, rng = R.next_f32_masked(seed, alive)
            N = np.where(_dot(direction, N)[:, None] > 0.0, -N, N)

            refl = mats.reflectivity[mat]
            refr = mats.refractivity[mat]
            m_spec = alive & (rng < refl)
            m_diel = alive & ~m_spec & (rng < refl + refr)
            m_diff = alive & ~m_spec & ~m_diel

            Rdir = np.zeros_like(direction)
            new_in_medium = in_medium.copy()
            new_last_spec = last_specular.copy()
            new_trans = transmission.copy()

            # -- specular mirror (renderer.cpp:370-375)
            refl_dir = (
                direction - np.float32(2.0) * _dot(N, direction)[:, None] * N
            ).astype(np.float32)
            Rdir = np.where(m_spec[:, None], refl_dir, Rdir)
            new_last_spec = np.where(m_spec, True, new_last_spec)
            new_trans = np.where(
                m_spec[:, None],
                (transmission * mats.albedo[mat] * medium_scale).astype(np.float32),
                new_trans,
            )

            # -- dielectric (renderer.cpp:376-406)
            if m_diel.any() or True:
                n1 = np.where(in_medium, mats.ior[mat], np.float32(1.0)).astype(np.float32)
                n2 = np.where(in_medium, np.float32(1.0), mats.ior[mat]).astype(np.float32)
                ior_ratio = (n1 / n2).astype(np.float32)
                cos_i = (-_dot(direction, N)).astype(np.float32)
                cos_theta2 = (
                    np.float32(1.0)
                    - ior_ratio * ior_ratio * (np.float32(1.0) - cos_i * cos_i)
                ).astype(np.float32)
                can_refract = cos_theta2 > 0.0
                a = n1 - n2
                b = n1 + n2
                r0 = ((a * a) / (b * b)).astype(np.float32)
                c = (np.float32(1.0) - cos_i).astype(np.float32)
                fresnel = (
                    r0 + (np.float32(1.0) - r0) * (c * c * c * c * c)
                ).astype(np.float32)
                seed, r_fr = R.next_f32_masked(seed, m_diel & can_refract)
                must_refract = m_diel & can_refract & (r_fr > fresnel)
                with np.errstate(invalid="ignore"):
                    refract_dir = (
                        ior_ratio[:, None] * direction
                        + (ior_ratio * cos_i - np.sqrt(np.abs(cos_theta2)))[:, None] * N
                    ).astype(np.float32)
                Rdir = np.where(
                    m_diel[:, None],
                    np.where(must_refract[:, None], refract_dir, refl_dir),
                    Rdir,
                )
                new_last_spec = np.where(m_diel, True, new_last_spec)
                new_trans = np.where(
                    m_diel[:, None],
                    (transmission * mats.albedo[mat] * medium_scale).astype(np.float32),
                    new_trans,
                )
                new_in_medium = np.where(must_refract, ~in_medium, new_in_medium)

            # -- diffuse + NEE + RR (renderer.cpp:407-459)
            seed, cos_dir = self._cosine_hemisphere(seed, N, m_diff)
            Rdir = np.where(m_diff[:, None], cos_dir, Rdir)
            cos_theta = _dot(N, cos_dir).astype(np.float32)
            brdf = (mats.albedo[mat] * F32_INV_PI).astype(np.float32)

            if light_count > 0:
                seed, li = R.next_u32_masked(seed, m_diff)
                with np.errstate(over="ignore"):
                    li = (li % np.uint32(light_count)).astype(np.int64)
                light_inst = light_list[li]
                seed, su = R.next_f32_masked(seed, m_diff)
                seed, sv0 = R.next_f32_masked(seed, m_diff)
                sv = (sv0 * (np.float32(1.0) - su)).astype(np.float32)
                seed, ti = R.next_u32_masked(seed, m_diff)
                with np.errstate(over="ignore"):
                    tri_local = (
                        ti.astype(np.uint32)
                        % h.inst_tri_count[light_inst].astype(np.uint32)
                    ).astype(np.int64)
                tri_idx = h.inst_tri_offset[light_inst].astype(np.int64) + tri_local
                w = (np.float32(1.0) - su - sv).astype(np.float32)
                p_pos = (
                    su[:, None] * h.samp_v0[tri_idx]
                    + sv[:, None] * h.samp_v2[tri_idx]
                    + w[:, None] * h.samp_v1[tri_idx]
                ).astype(np.float32)
                p_nrm = _normalize(
                    su[:, None] * h.samp_n0[tri_idx]
                    + sv[:, None] * h.samp_n2[tri_idx]
                    + w[:, None] * h.samp_n1[tri_idx]
                ).astype(np.float32)
                IL = (p_pos - I).astype(np.float32)
                L = _normalize(IL).astype(np.float32)
                SO = (I + F32_EPSILON * L).astype(np.float32)
                sr_depth = (
                    np.sqrt(_dot(IL, IL)) - np.float32(2.0) * F32_EPSILON
                ).astype(np.float32)
                with np.errstate(divide="ignore"):
                    falloff = (np.float32(1.0) / _dot(IL, IL)).astype(np.float32)
                cos_o = _dot(N, L).astype(np.float32)
                cos_li = _dot(p_nrm, -L).astype(np.float32)
                nee_ok = m_diff & (cos_o > 0.0) & (cos_li > 0.0)
                occ = self._occluded(SO, L, sr_depth, nee_ok)
                contrib_mask = nee_ok & ~occ
                SA = (cos_li * inst_area[light_inst] * falloff).astype(np.float32)
                lmat = h.inst_material[light_inst].astype(np.int64)
                l_emit = (
                    mats.emission_strength[lmat, None] * mats.emission_color[lmat]
                ).astype(np.float32)
                Ld = (
                    l_emit * SA[:, None] * brdf * cos_o[:, None] * np.float32(light_count)
                ).astype(np.float32)
                energy = np.where(
                    contrib_mask[:, None],
                    (energy + transmission * Ld).astype(np.float32),
                    energy,
                )

            p = np.clip(np.max(transmission, axis=1), 0.0, 1.0).astype(np.float32)
            seed, r_rr = R.next_f32_masked(seed, m_diff)
            rr_kill = m_diff & (p < r_rr)
            alive = alive & ~rr_kill
            m_diff_live = m_diff & ~rr_kill
            with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
                rr_scale = (np.float32(1.0) / p).astype(np.float32)
                diffuse_pdf = (cos_theta * F32_INV_PI).astype(np.float32)
                inv_pdf = (np.float32(1.0) / diffuse_pdf).astype(np.float32)
                new_trans = np.where(
                    m_diff_live[:, None],
                    (
                        transmission
                        * cos_theta[:, None] * inv_pdf[:, None] * brdf
                        * medium_scale * rr_scale[:, None]
                    ).astype(np.float32),
                    new_trans,
                )
            new_last_spec = np.where(m_diff_live, False, new_last_spec)

            origin = np.where(
                alive[:, None], (I + F32_EPSILON * Rdir).astype(np.float32), origin
            )
            direction = np.where(alive[:, None], Rdir, direction)
            transmission = np.where(alive[:, None], new_trans, transmission)
            last_specular = np.where(alive, new_last_spec, last_specular)
            in_medium = np.where(alive, new_in_medium, in_medium)

        return seed, energy

    # -------------------------------------------------------------- frames
    def render(self, width: int, height: int, spp: int, total_samples: int = 0,
               rows_per_batch: int | None = None):
        """One frame of spp samples; returns radiance sums [H, W, 3].

        ``rows_per_batch`` bounds memory at large resolutions (the brute
        force intersection builds [lanes, tri_chunk] temporaries)."""
        if rows_per_batch is None:
            rows_per_batch = max(1, (1 << 22) // (width * self.tri_chunk) * 64)
            rows_per_batch = min(height, max(8, rows_per_batch))
        out = np.zeros((height, width, 3), np.float32)
        for y0 in range(0, height, rows_per_batch):
            y1 = min(y0 + rows_per_batch, height)
            out[y0:y1] = self.render_rows(width, y0, y1, spp, total_samples)
        return out

    def render_rows(self, width: int, y0: int, y1: int, spp: int,
                    total_samples: int = 0) -> np.ndarray:
        """Rows [y0, y1) of the frame ``render`` returns: every pixel owns
        its own RNG stream, so row bands can be rendered apart (and in
        parallel) and stacked."""
        n = (y1 - y0) * width
        lane = np.arange(y0 * width, y1 * width, dtype=np.int64)
        py, px = np.divmod(lane, width)
        # row-major pixelIndex = x + y * width (renderer.cpp:167)
        seed = R.pixel_seed(lane, total_samples)
        acc = np.zeros((n, 3), np.float32)
        for _ in range(spp):
            seed, o, d = self._primary_rays(seed, px, py)
            seed, e = self._trace(seed, o, d)
            acc += e
        return acc.reshape(y1 - y0, width, 3)
