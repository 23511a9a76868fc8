"""Scene layer tests: mesh loading quirks, transforms, instances, materials,
scene compile invariants (reference: mesh.cpp/h, bvh.cpp Instance, scene.cpp)."""

import numpy as np

from surf_tpu.core import transform as tf
from surf_tpu.scene import builtin
from surf_tpu.scene.compile import HostCompiled
from surf_tpu.scene.material import Material
from surf_tpu.scene.mesh import Mesh, make_cube, make_plane


def test_vertex_swap_quirk():
    """Triangle ctor swaps file vertices 0/1 (mesh.h:19); normals unswapped."""
    fv = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    fn = np.array([[[0, 0, 1], [0, 1, 0], [1, 0, 0]]], np.float32)
    m = Mesh.from_file_triangles(fv, fn)
    assert np.array_equal(m.v0[0], [1, 0, 0])  # stored v0 = file vertex 1
    assert np.array_equal(m.v1[0], [0, 0, 0])
    assert np.array_equal(m.v2[0], [0, 1, 0])
    assert np.array_equal(m.n0[0], [0, 0, 1])  # normals keep file order
    assert np.array_equal(m.n1[0], [0, 1, 0])


def test_centroid_0333():
    fv = np.array([[[3, 0, 0], [0, 3, 0], [0, 0, 3]]], np.float32)
    fn = np.zeros((1, 3, 3), np.float32)
    m = Mesh.from_file_triangles(fv, fn)
    assert np.allclose(m.centroid[0], np.float32(0.333) * 3.0)  # not 1/3


def test_plane_triangulation_matches_reference_fan():
    m = make_plane()
    assert m.tri_count == 2


def test_glm_transform_composition():
    # glm::scale(glm::translate(I, t), s) = T @ S: translation unscaled.
    M = tf.scale(tf.translate(tf.identity(), [1, 2, 3]), [2, 2, 2])
    p = tf.apply_point(M, np.array([1, 0, 0], np.float32))
    assert np.allclose(p, [3, 2, 3])


def test_rotate_matches_rodrigues():
    M = tf.rotate(tf.identity(), np.pi / 2, [0, 0, 1])
    p = tf.apply_point(M, np.array([1, 0, 0], np.float32))
    assert np.allclose(p, [0, 1, 0], atol=1e-6)


def test_instance_area_scales_quadratically():
    from surf_tpu.scene.instance import Instance
    cube = make_cube()
    mat = Material(albedo=[1, 1, 1])
    a1 = Instance(cube, mat, tf.identity()).area
    a2 = Instance(cube, mat, tf.scale(tf.identity(), [2, 2, 2])).area
    assert np.isclose(a2, 4 * a1, rtol=1e-5)


def test_is_light_cpu_semantics():
    assert Material(emission_strength=1.0, emission_color=[1, 0, 0]).is_light()
    assert not Material(emission_strength=0.0, emission_color=[1, 0, 0]).is_light()
    assert not Material(emission_strength=1.0, emission_color=[0, 0, 0]).is_light()


def test_indoor_scene_shape():
    scene = builtin.make_indoor_scene()
    assert len(scene.instances) == 11
    assert scene.light_indices == [1, 2]  # cubeL, cubeR
    host = HostCompiled(scene)
    assert host.static.num_lights == 2
    # material dedupe: 8 unique materials (floor shared by 4 instances)
    assert host.materials.albedo.shape[0] == 8
    # instance->triangle ranges cover all triangles exactly
    total = host.inst_tri_offset[-1] + host.inst_tri_count[-1]
    assert total == host.static.tri_count


def test_scene_update_rotates_instance3():
    scene = builtin.make_diffuse_box_scene()
    host = HostCompiled(builtin.make_indoor_scene())
    before = host.samp_v0.copy()
    host.update(0.5)
    after = host.samp_v0
    o, c = host.inst_tri_offset[3], host.inst_tri_count[3]
    assert not np.allclose(before[o:o + c], after[o:o + c])  # susanne0 moved
    assert np.allclose(before[:o], after[:o])  # others untouched


def test_flattening_memory_scales_with_instances():
    """Documented departure (DESIGN.md §4a, VERDICT r3 #8): the device
    scene flattens instances to world space, so stored triangles — and
    every traversal table — grow linearly with the instance count (the
    reference's TLAS→BLAS shares one BLAS per mesh, bvh.cpp:481-513).
    This pins the trade so a future two-level device path can remove it
    consciously."""
    from surf_tpu.scene.instance import Instance
    from surf_tpu.scene.scene import Scene, SceneBackground

    cube = make_cube()
    mat = Material(albedo=np.array([0.5, 0.5, 0.5], np.float32))

    def scene_with(n):
        insts = [
            Instance(cube, mat,
                     tf.translate(tf.identity(), [2.0 * i, 0.0, 0.0]))
            for i in range(n)
        ]
        return HostCompiled(Scene(SceneBackground(), insts))

    h2 = scene_with(2)
    h8 = scene_with(8)
    assert h2.static.tri_count == 2 * cube.tri_count
    assert h8.static.tri_count == 8 * cube.tri_count
    # traversal tables scale with stored (instanced) tris, not unique tris
    occ2 = h2.render_scene.trace.tri_v0.shape[0]
    occ8 = h8.render_scene.trace.tri_v0.shape[0]
    assert occ2 == 2 * cube.tri_count and occ8 == 8 * cube.tri_count


def test_camera_view_plane_reference_values():
    cam = builtin.make_indoor_camera(1280, 720)
    fp, uv, vv = cam.view_plane()
    # forward = +z from (0,0,-7) to origin; right=(1,0,0); up=(0,1,0)
    assert np.allclose(cam.forward, [0, 0, 1])
    assert np.allclose(cam.right(), [1, 0, 0])
    # viewport height = 2 * tan(35deg) * 7
    vh = 2.0 * np.tan(np.radians(70.0) / 2) * 7.0
    assert np.isclose(-vv[1], vh, rtol=1e-4)
    assert np.isclose(uv[0], vh * 1280.0 / 720.0, rtol=1e-4)
