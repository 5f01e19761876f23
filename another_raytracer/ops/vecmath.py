"""Batched 3-vector math on ``[..., 3]`` arrays.

Replaces the reference's scalar ``vec3`` class (src/core/vec3.h) with
vectorized jnp ops over a trailing axis of size 3, so every operation is
data-parallel instead of scalar code.  Also hosts the closed-form
sphere/disk samplers replacing the reference's rejection loops
(src/core/vec3.h:117-143) — rejection sampling is data-dependent control flow
that XLA cannot express efficiently; the closed-form maps are exact samplers
of the same distributions.
"""

from __future__ import annotations

import jax.numpy as jnp

NEAR_ZERO_EPS = 1e-8  # reference: vec3::near_zero epsilon (vec3.h:51)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length_squared(a):
    return jnp.sum(a * a, axis=-1)


def length(a):
    return jnp.sqrt(length_squared(a))


def unit(a):
    """Normalize along the last axis (safe for zero vectors: returns 0)."""
    n = length(a)[..., None]
    return a / jnp.where(n > 0, n, 1.0)


def near_zero(a):
    """True where all components are < 1e-8 in magnitude (vec3.h:49-53)."""
    return jnp.all(jnp.abs(a) < NEAR_ZERO_EPS, axis=-1)


def reflect(v, n):
    """Mirror reflection about unit normal n (vec3.h:145-147)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """Snell refraction via perpendicular/parallel decomposition
    (vec3.h:149-154).  ``uv`` must be unit length; ``etai_over_etat`` is
    broadcast over the batch."""
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    # The 1e-12 floor keeps reverse-mode sqrt gradients finite at the total-
    # internal-reflection boundary (the refracted branch is discarded by a
    # select there, but an inf cotangent would still poison shared inputs).
    r_out_parallel = (
        -jnp.sqrt(jnp.maximum(jnp.abs(1.0 - length_squared(r_out_perp)), 1e-12))[..., None] * n
    )
    return r_out_perp + r_out_parallel


# --- Samplers (closed-form equivalents of vec3.h:117-143) ------------------


def unit_vector_from_uniforms(u1, u2):
    """Uniform direction on the unit sphere from two uniforms.

    Closed-form equal-area map replacing the reference's normalized rejection
    sample ``random_unit_vector`` (vec3.h:125-127); identical distribution.
    """
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def in_unit_sphere_from_uniforms(u1, u2, u3):
    """Uniform point in the unit ball, replacing the rejection loop
    ``random_in_unit_sphere`` (vec3.h:117-123): uniform direction scaled by
    cbrt of a uniform radius variable."""
    d = unit_vector_from_uniforms(u1, u2)
    return d * jnp.cbrt(u3)[..., None]


def in_unit_disk_from_uniforms(u1, u2):
    """Uniform point in the unit disk (z=0), replacing the rejection loop
    ``random_in_unit_disk`` (vec3.h:137-143)."""
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    z = jnp.zeros_like(r)
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def in_hemisphere(d, normal):
    """Flip d into the hemisphere around ``normal``
    (reference: random_in_hemisphere, vec3.h:129-135)."""
    same = dot(d, normal) > 0.0
    return jnp.where(same[..., None], d, -d)
