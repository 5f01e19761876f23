"""another_raytracer — a JAX-native, differentiable path-tracing framework.

A from-scratch JAX/XLA/Pallas re-design of the capability surface of the
reference CPU ray tracer ``blackccpie/another_raytracer`` (Ray Tracing In One
Weekend + The Next Week): sphere / moving-sphere / axis-rect / box / triangle
primitives, BVH acceleration, lambertian / metal / dielectric / diffuse-light /
isotropic materials, solid / checker / Perlin-noise / image / barycentric
textures, thin-lens camera with defocus and motion blur, constant-density
participating media, translate / rotate-y instancing, wavefront .obj mesh
loading, adaptive subsampling, and the nine canonical scenes.

Architecture (accelerator-first, not a translation):
  * flat SoA scene arrays instead of a pointer-based polymorphic graph
    (reference: src/engine/hittable.h, src/primitives/*),
  * an iterative masked wavefront bounce loop (``lax.scan``) instead of the
    recursive integrator (reference: src/engine/engine.h:447-466),
  * counter-based threefry RNG keyed on (pixel, sample, bounce, dim) instead of
    a shared ``std::mt19937`` (reference: src/utils/tracer_utils.h:27-31),
  * sharding over ``jax.sharding.Mesh`` axes for pixels (stripes) and samples
    (parallel_images + psum) instead of a 4-thread pool
    (reference: src/utils/threadpool.h),
  * end-to-end differentiability (not present in the reference).
"""

__version__ = "0.1.0"

from another_raytracer.config import RenderConfig, RenderMode
