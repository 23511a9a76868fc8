"""Scene compiler: host Scene -> device-resident flattened SoA arrays.

The analog of the reference's GPUBatcher + GPUScene upload path
(reference/sources/scene.cpp:61-258): a host pass that flattens meshes,
BVHs, materials, instances and lights into global arrays, which then live in
device memory (replicated per card) for the wavefront kernels.

Design departure (documented per SURVEY.md §2 BVH rows): instead of the
reference's two-level TLAS->instance->BLAS traversal with per-instance ray
transforms (bvh.cpp:481-513), instances are *pre-transformed to world space*
at compile time and a single flattened BVH is built over all world
triangles, so a traversal lane needs no nested walk or per-lane matrix
loads, while animation still only re-transforms the moved instance's
triangle slice and refits (see ``HostCompiled.update``).  The two-level
structures remain available on the host (accel.build_blas / build_tlas,
accel/twolevel.py) and are exercised by the test suite for the
reference-shaped API.

Gradient plumbing: ``RenderScene`` carries the differentiable leaves
(material table, sampling-geometry arrays); the traversal arrays are derived
and treated as detached — kernels re-intersect the *chosen* primitive
differentiably (see wavefront/integrator.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..accel import builder
from ..accel.traverse import TraceArrays, build_skiplinks, skiplink_boxes
from .material import build_material_table
from .scene import Scene


class RenderScene(NamedTuple):
    """Device pytree consumed by the wavefront kernels. All jnp arrays."""

    # traversal set (leaf-ordered, detached)
    trace: TraceArrays
    tri_inst: jnp.ndarray      # [T] int32, leaf-ordered instance id
    tri_n0: jnp.ndarray        # [T,3] leaf-ordered world normals (M @ n, unnormalized)
    tri_n1: jnp.ndarray
    tri_n2: jnp.ndarray
    tri_uv0: jnp.ndarray       # [T,2] leaf-ordered UVs (fetched, unused — parity)
    tri_uv1: jnp.ndarray
    tri_uv2: jnp.ndarray
    perm: jnp.ndarray          # [T] int32: leaf slot -> original (sampling) id
    # sampling set (original instance-contiguous order, differentiable)
    samp_v0: jnp.ndarray       # [T,3]
    samp_v1: jnp.ndarray
    samp_v2: jnp.ndarray
    samp_n0: jnp.ndarray
    samp_n1: jnp.ndarray
    samp_n2: jnp.ndarray
    # instances
    inst_tri_offset: jnp.ndarray  # [I] int32 into samp arrays
    inst_tri_count: jnp.ndarray   # [I] int32
    inst_area: jnp.ndarray        # [I] float32 (transformed surface area)
    inst_material: jnp.ndarray    # [I] int32
    # materials (primary gradient targets)
    mat_albedo: jnp.ndarray           # [M,3]
    mat_emission_color: jnp.ndarray   # [M,3]
    mat_absorption: jnp.ndarray       # [M,3]
    mat_emission_strength: jnp.ndarray  # [M]
    mat_reflectivity: jnp.ndarray     # [M]
    mat_refractivity: jnp.ndarray     # [M]
    mat_ior: jnp.ndarray              # [M]
    mat_is_light: jnp.ndarray         # [M] bool
    # lights
    light_inst: jnp.ndarray    # [L] int32 instance ids (L >= 1; padded if 0)
    # background
    bg_type: jnp.ndarray       # scalar int32 (0 solid / 1 gradient)
    bg_color: jnp.ndarray      # [3]
    bg_gradient_a: jnp.ndarray # [3]
    bg_gradient_b: jnp.ndarray # [3]


class SceneStatic(NamedTuple):
    """Hashable static companion passed as a jit-static argument."""

    num_lights: int
    tri_count: int


def _dedupe_materials(scene: Scene):
    mats, ids = [], {}
    for inst in scene.instances:
        if id(inst.material) not in ids:
            ids[id(inst.material)] = len(mats)
            mats.append(inst.material)
    inst_material = np.array([ids[id(i.material)] for i in scene.instances], np.int32)
    return mats, inst_material


def compile_scene(scene: Scene) -> tuple[RenderScene, SceneStatic]:
    host = HostCompiled(scene)
    return host.render_scene, host.static


class HostCompiled:
    """Keeps the host-side arrays so animation updates can be incremental
    (only the moved instance's triangle slice is re-transformed and the BVH
    refit — the analog of GPUScene::update's instance+TLAS re-upload,
    scene.cpp:267-282)."""

    def __init__(self, scene: Scene, render_min_leaf: int = 4):
        self.scene = scene
        self.render_min_leaf = render_min_leaf
        mats, inst_material = _dedupe_materials(scene)
        self.materials = build_material_table(mats)
        self.inst_material = inst_material

        v0s, v1s, v2s, n0s, n1s, n2s = [], [], [], [], [], []
        uv0s, uv1s, uv2s = [], [], []
        offsets, counts = [], []
        off = 0
        for inst in scene.instances:
            w = inst.world_triangles()
            v0s.append(w[0]); v1s.append(w[1]); v2s.append(w[2])
            n0s.append(w[3]); n1s.append(w[4]); n2s.append(w[5])
            uv0s.append(inst.mesh.uv0); uv1s.append(inst.mesh.uv1); uv2s.append(inst.mesh.uv2)
            offsets.append(off)
            counts.append(inst.mesh.tri_count)
            off += inst.mesh.tri_count
        self.samp_v0 = np.concatenate(v0s); self.samp_v1 = np.concatenate(v1s)
        self.samp_v2 = np.concatenate(v2s)
        self.samp_n0 = np.concatenate(n0s); self.samp_n1 = np.concatenate(n1s)
        self.samp_n2 = np.concatenate(n2s)
        self.uv0 = np.concatenate(uv0s); self.uv1 = np.concatenate(uv1s)
        self.uv2 = np.concatenate(uv2s)
        self.inst_tri_offset = np.asarray(offsets, np.int32)
        self.inst_tri_count = np.asarray(counts, np.int32)
        self.tri_inst = np.repeat(
            np.arange(len(scene.instances), dtype=np.int32), self.inst_tri_count
        )
        self._caps: dict[str, int] = {}
        self._rebuild_bvh()
        self._seen_version = scene.version

    def _cap(self, name: str, n: int, quantum: int = 1024) -> int:
        """Sticky capacity class for a topology-dependent array dimension:
        rounds n (+12.5% headroom) up to a quantum on first use and keeps
        that capacity until exceeded, so per-frame SAH rebuilds produce
        identically-shaped device arrays and the jitted render re-uses its
        compiled executable (VERDICT r3 item 4)."""
        c = self._caps.get(name, 0)
        if n > c:
            c = -(-int(n * 1.125 + 1) // quantum) * quantum
            self._caps[name] = c
        return c

    def _pad_node_boxes(self, boxes):
        """Pad skip-link boxes to the sticky node capacity with NaN rows
        (NaN fails every slab comparison — never hit)."""
        d_cap = self._cap("nodes", len(boxes))
        if len(boxes) == d_cap:
            return boxes
        out = np.full((d_cap, 6), np.nan, np.float32)
        out[:len(boxes)] = boxes
        return out

    def _rebuild_bvh(self):
        self.bvh = builder.build_blas(
            self.samp_v0, self.samp_v1, self.samp_v2,
            min_leaf=self.render_min_leaf,
            # bounded leaves keep a lane's run of triangle tests short
            max_leaf=8,
        )
        self._skip_order = None  # topology changed: rebuild skip links
        self._refresh_device()

    def _refit_bvh(self):
        lo, hi = builder.triangle_bounds(self.samp_v0, self.samp_v1, self.samp_v2)
        self.bvh = builder.refit(self.bvh, lo, hi)
        self._refresh_device(refit_only=True)

    def _refresh_device(self, refit_only: bool = False):
        perm = self.bvh.indices.astype(np.int64)
        refit_fast = refit_only and self._skip_order is not None
        if refit_fast:
            # Animation fast path (GPUScene::update analog,
            # scene.cpp:267-282): topology is unchanged, so the skip-link
            # preorder/meta are reused and only box values re-gather
            # (90 ms Python DFS -> ~1 ms), and the device scene is updated
            # with ._replace so unchanged arrays (materials, UVs, meta)
            # keep their device buffers instead of re-uploading.
            boxes = self._pad_node_boxes(
                skiplink_boxes(self.bvh, self._skip_order))
            meta = self._skip_meta
        else:
            boxes, meta, self._skip_order = build_skiplinks(
                self.bvh, return_order=True)
            # Capacity padding: NaN boxes never hit; pad meta is a
            # non-leaf whose skip jumps straight to the padded end, so a
            # lane that reaches the pad region pays one visit and exits.
            d_cap = self._cap("nodes", len(meta))
            boxes = self._pad_node_boxes(boxes)
            meta_pad = np.zeros((d_cap, 3), np.int32)
            meta_pad[:, 2] = d_cap
            meta_pad[:len(meta)] = meta
            meta = meta_pad
            self._skip_meta = meta
        tv0 = self.samp_v0[perm]
        tv1 = self.samp_v1[perm]
        tv2 = self.samp_v2[perm]
        j = jnp.asarray
        if refit_fast:
            self.render_scene = self.render_scene._replace(
                trace=self.render_scene.trace._replace(
                    tri_v0=j(tv0), tri_v1=j(tv1), tri_v2=j(tv2),
                    node_boxes=j(boxes),
                ),
                tri_n0=j(self.samp_n0[perm]),
                tri_n1=j(self.samp_n1[perm]),
                tri_n2=j(self.samp_n2[perm]),
                samp_v0=j(self.samp_v0),
                samp_v1=j(self.samp_v1),
                samp_v2=j(self.samp_v2),
                samp_n0=j(self.samp_n0),
                samp_n1=j(self.samp_n1),
                samp_n2=j(self.samp_n2),
                inst_area=j(np.array(
                    [i.area for i in self.scene.instances], np.float32)),
            )
            return
        scene = self.scene
        bg = scene.background
        light_inst = np.asarray(scene.light_indices, np.int32)
        if len(light_inst) == 0:
            light_inst = np.zeros(1, np.int32)  # padded; gated by num_lights

        j = jnp.asarray
        self.render_scene = RenderScene(
            trace=TraceArrays(
                tri_v0=j(tv0),
                tri_v1=j(tv1),
                tri_v2=j(tv2),
                node_boxes=j(boxes),
                node_meta=j(meta),
            ),
            tri_inst=j(self.tri_inst[perm]),
            tri_n0=j(self.samp_n0[perm]),
            tri_n1=j(self.samp_n1[perm]),
            tri_n2=j(self.samp_n2[perm]),
            tri_uv0=j(self.uv0[perm]),
            tri_uv1=j(self.uv1[perm]),
            tri_uv2=j(self.uv2[perm]),
            perm=j(perm.astype(np.int32)),
            samp_v0=j(self.samp_v0),
            samp_v1=j(self.samp_v1),
            samp_v2=j(self.samp_v2),
            samp_n0=j(self.samp_n0),
            samp_n1=j(self.samp_n1),
            samp_n2=j(self.samp_n2),
            inst_tri_offset=j(self.inst_tri_offset),
            inst_tri_count=j(self.inst_tri_count),
            inst_area=j(
                np.array([i.area for i in self.scene.instances], np.float32)
            ),
            inst_material=j(self.inst_material),
            mat_albedo=j(self.materials.albedo),
            mat_emission_color=j(self.materials.emission_color),
            mat_absorption=j(self.materials.absorption),
            mat_emission_strength=j(self.materials.emission_strength),
            mat_reflectivity=j(self.materials.reflectivity),
            mat_refractivity=j(self.materials.refractivity),
            mat_ior=j(self.materials.ior),
            mat_is_light=j(self.materials.is_light),
            light_inst=j(light_inst),
            bg_type=jnp.int32(bg.type),
            bg_color=j(bg.color),
            bg_gradient_a=j(bg.gradient_a),
            bg_gradient_b=j(bg.gradient_b),
        )
        self.static = SceneStatic(
            num_lights=len(self.scene.light_indices),
            tri_count=int(len(self.samp_v0)),
        )

    def update(self, delta_time: float, rebuild: bool = False):
        """Advance the scene animation and refresh device arrays.

        ``rebuild=True`` forces a full SAH rebuild (BASELINE config 4);
        otherwise the BVH is refit in place."""
        self.scene.update(delta_time)
        self.refresh(rebuild=rebuild)

    def refresh(self, rebuild: bool = False):
        """Re-transform triangle slices ONLY for instances whose transform
        changed since the last refresh (Instance.version), then
        refit/rebuild.  On the indoor animation this touches one instance
        instead of all eleven (VERDICT r1 item 3)."""
        seen = getattr(self, "_inst_versions", None)
        if seen is None:
            seen = [-1] * len(self.scene.instances)
        for i, inst in enumerate(self.scene.instances):
            v = getattr(inst, "version", 0)
            if v == seen[i]:
                continue
            seen[i] = v
            o = self.inst_tri_offset[i]
            c = self.inst_tri_count[i]
            w = inst.world_triangles()
            self.samp_v0[o:o + c] = w[0]; self.samp_v1[o:o + c] = w[1]
            self.samp_v2[o:o + c] = w[2]
            self.samp_n0[o:o + c] = w[3]; self.samp_n1[o:o + c] = w[4]
            self.samp_n2[o:o + c] = w[5]
        self._inst_versions = seen
        if rebuild:
            self._rebuild_bvh()
        else:
            self._refit_bvh()
