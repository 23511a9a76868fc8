"""surf_tpu — a differentiable wavefront path tracer in JAX.

A JAX re-design of the capabilities of ``nemjit001/surf-path-tracer``, run
on NVIDIA GPUs (and on the CPU for tests):

- ``core``      — vector math, bit-exact WangHash/xorshift32 RNG, sampling,
                  intersection primitives (reference: headers/surf_math.h,
                  sources/surf_math.cpp, shaders/wavefront_common.glsl).
- ``scene``     — OBJ meshes, materials, instances, camera, the built-in
                  indoor test scene, and the scene compiler that flattens
                  everything into device-resident SoA arrays (reference:
                  sources/mesh.cpp, sources/scene.cpp GPUBatcher, main.cpp).
- ``accel``     — binned-SAH BVH builder (native C++ + NumPy fallback),
                  TLAS/BLAS, refit, the skip-link traversal (XLA walk) and
                  its Pallas GPU kernel (reference: sources/bvh.cpp,
                  shaders/ray_extend.comp).
- ``reference`` — slow, trusted NumPy oracle renderer replicating the CPU
                  megakernel semantics bit-for-bit at fixed seed (reference:
                  sources/renderer.cpp:331-463).
- ``wavefront`` — the forward path: raygen/extend/shade/connect/finalize
                  as jitted stages with an on-device ``lax.while_loop`` wave
                  loop (reference: shaders/*.comp, renderer.cpp:939-1157).
- ``diff``      — differentiable estimator (detached discrete sampling) and
                  finite-difference validation harness.
- ``dist``      — multi-card sharding over a ``jax.sharding.Mesh`` (pixel
                  lanes sharded under ``shard_map``, scene replicated, psum
                  gradient reduction).
- ``app``       — CLI, config, metrics, PNG/NPY image output.
"""

__version__ = "0.1.0"
