"""Column-SoA 3-vectors: three separate arrays instead of a trailing axis.

Why: every component of every ray is then a contiguous ``[B]`` vector, so
elementwise work reads and writes whole vectors, and no layout ever pads a
minor dimension of 3 (accelerators that tile arrays in wide lanes would
pad ``f32[B, 3]`` many times over wherever XLA materializes it: loop
carries, scan residuals for backward, fusion boundaries).  This is the data
layout the whole device path uses for per-ray state; ``[N, 3]`` remains
only for small host-built scene tables (gathered columns fuse into
arithmetic).

``V3`` is a pytree (NamedTuple), so it passes through jit/scan/while/vmap
and arithmetic is defined elementwise with normal broadcasting per
component.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

NEAR_ZERO_EPS = 1e-8  # reference: vec3::near_zero epsilon (vec3.h:51)


class V3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # --- arithmetic (elementwise, broadcasting like jnp) -------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # --- conversions -------------------------------------------------------
    @staticmethod
    def from_array(a):
        """[..., 3] -> V3 of [...] components."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def of(x, y, z, dtype=jnp.float32):
        return V3(jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype))

    @staticmethod
    def full_like(t, x, y, z):
        return V3(jnp.full_like(t, x), jnp.full_like(t, y), jnp.full_like(t, z))

    @staticmethod
    def zeros(shape, dtype=jnp.float32):
        z = jnp.zeros(shape, dtype)
        return V3(z, z, z)

    def stack(self):
        """V3 -> [..., 3] (boundary/API use only)."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    def map(self, f):
        return V3(f(self.x), f(self.y), f(self.z))


# --- vector ops ------------------------------------------------------------


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length_squared(a: V3):
    return dot(a, a)


def length(a: V3):
    return jnp.sqrt(length_squared(a))


def unit(a: V3) -> V3:
    n = length(a)
    return a * (1.0 / jnp.where(n > 0, n, 1.0))


def near_zero(a: V3):
    return (
        (jnp.abs(a.x) < NEAR_ZERO_EPS)
        & (jnp.abs(a.y) < NEAR_ZERO_EPS)
        & (jnp.abs(a.z) < NEAR_ZERO_EPS)
    )


def where(mask, a: V3, b: V3) -> V3:
    return V3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def reflect(v: V3, n: V3) -> V3:
    """Mirror reflection about unit normal n (vec3.h:145-147)."""
    return v - n * (2.0 * dot(v, n))


def refract(uv: V3, n: V3, etai_over_etat) -> V3:
    """Snell refraction (vec3.h:149-154); uv must be unit.  The 1e-12 floor
    keeps reverse-mode sqrt gradients finite at total internal reflection."""
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)
    r_out_perp = (uv + n * cos_theta) * etai_over_etat
    r_out_parallel = n * (
        -jnp.sqrt(jnp.maximum(jnp.abs(1.0 - length_squared(r_out_perp)), 1e-12))
    )
    return r_out_perp + r_out_parallel


# --- samplers (closed-form equivalents of vec3.h:117-143) ------------------


def unit_vector_from_uniforms(u1, u2) -> V3:
    """Uniform direction on the unit sphere (replaces random_unit_vector's
    rejection loop, vec3.h:125-127; identical distribution)."""
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u2
    return V3(r * jnp.cos(phi), r * jnp.sin(phi), z)


def in_unit_sphere_from_uniforms(u1, u2, u3) -> V3:
    """Uniform point in the unit ball (replaces random_in_unit_sphere,
    vec3.h:117-123)."""
    return unit_vector_from_uniforms(u1, u2) * jnp.cbrt(u3)


def in_hemisphere_from_uniforms(u1, u2, u3, normal: V3) -> V3:
    """Uniform point in the unit half-ball about ``normal`` (replaces
    random_in_hemisphere's flip of a rejection-sampled ball point,
    vec3.h:129-135; identical distribution).  Unused by the stock material
    set — the reference keeps it for the commented-out hemispherical
    lambertian variant (material.h:31-33) — provided for API parity."""
    p = in_unit_sphere_from_uniforms(u1, u2, u3)
    return where(dot(p, normal) > 0.0, p, -p)


def in_unit_disk_from_uniforms(u1, u2):
    """Uniform (x, y) in the unit disk (replaces random_in_unit_disk,
    vec3.h:137-143).  Returns (x, y) scalars."""
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    return r * jnp.cos(phi), r * jnp.sin(phi)


def to_numpy(v: V3):
    """Host-side V3 -> np.ndarray [..., 3] (stacks in numpy, so no padded
    device buffer is ever materialized)."""
    import numpy as np

    return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], axis=-1)


def rotate(rot_rows, v: V3) -> V3:
    """Apply a gathered rotation matrix to V3: ``rot_rows`` is a V3-of-V3
    ((r00,r01,r02),(r10,...),...) i.e. a 3-tuple of V3 rows."""
    r0, r1, r2 = rot_rows
    return V3(dot(r0, v), dot(r1, v), dot(r2, v))
