"""Texture evaluation, emission, and branchless material scatter (column SoA).

The reference dispatches scatter through ``material::scatter`` virtual calls
(src/rendering/material.h) and textures through ``texture::value``
(src/rendering/texture.h).  Here both are data: every ray evaluates the small
set of closed-form candidates and a masked select keyed on the material /
texture kind picks the winner — no divergent control flow.
All colors/vectors are ``V3`` of [B] arrays (see ops/vec3.py for why).

Scatter contracts (reference locations):
  * lambertian: dir = normal + random_unit_vector, near-zero fallback to the
    normal, albedo from texture (material.h:20-43);
  * metal: reflect(unit(d), n) + fuzz * random_in_unit_sphere, absorbed when
    the scattered dir points below the surface (material.h:45-61);
  * dielectric: attenuation 1, ratio 1/ir vs ir by front_face, TIR test,
    Schlick reflectance vs a uniform (material.h:63-99);
  * diffuse_light: never scatters, emits its texture (material.h:101-118);
  * isotropic: uniform scatter in the unit ball (material.h:120-135).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from another_raytracer.models import scene as scene_lib
from another_raytracer.ops import rng, vec3
from another_raytracer.ops.gather import Lookup
from another_raytracer.ops.intersect import HitRecord
from another_raytracer.ops.vec3 import V3

PERLIN_N = scene_lib.PERLIN_POINT_COUNT

# Three switches around the packed-atlas texel fetch, all off by default
# because none of them made it faster where they were tried; the fetch is
# bound by random reads of the atlas in device memory.  Forward-only
# (fast_texel), like the packed-atlas path itself; every setting gives
# bit-identical output.
#   ATLAS_BARRIER: fence the gather out of its fusion (optimization_barrier).
#   ATLAS_COMPACT: gather texels only for lanes whose WINNER texture is the
#     image.  Lanes with rank <= B//DIV are gathered into a compact buffer
#     and scattered back; if more than B//DIV lanes need texels (cond
#     guard), the full-width gather runs instead.  Its cumsum + searchsorted
#     + scatter cost more than the gather it shrinks.
#   ATLAS_IDX_ZERO: route non-image-winner lanes to texel 0 (their fetched
#     value is select-discarded).
ATLAS_BARRIER = False
ATLAS_COMPACT = False
ATLAS_COMPACT_DIV = 4
ATLAS_COMPACT_MIN_B = 32768
ATLAS_IDX_ZERO = False


# --------------------------------------------------------------------------
# Perlin noise (vectorized port of the behavior of src/rendering/perlin.h)
# --------------------------------------------------------------------------


def perlin_noise(scene, perlin_ids, p: V3):
    """Gradient Perlin noise per ray ([B] in roughly [-1, 1]).

    Lattice hash perm_x[i&255] ^ perm_y[j&255] ^ perm_z[k&255] and trilinear
    Hermite-smoothed gradient interpolation exactly as perlin.h:29-96; each
    noise texture has its own tables (texture.h:52-65).

    All table reads go through one-hot matmul ``Lookup``s (ops/gather.py)
    instead of the direct ``perm[pid, ax, idx]`` / ``ranvec[gidx]`` form's
    30 distinct [B]-indexed gathers per evaluation.  The lattice reads
    collapse to 3 one-hot builds (the +1 neighbor reads a pre-rolled copy
    of the table through the SAME one-hot) and the 8 corner gradients to 8
    one-hot builds; values are exact because the 0/1 one-hot times f32
    tables reconstructs f32 under precision=HIGHEST.  Whether direct
    gathers are faster on the GPU is an open question (ROADMAP).
    """
    pid = jnp.clip(perlin_ids, 0, scene.per_perm.shape[0] - 1)
    fx, fy, fz = jnp.floor(p.x), jnp.floor(p.y), jnp.floor(p.z)
    u, v, w = p.x - fx, p.y - fy, p.z - fz
    i = fx.astype(jnp.int32)
    j = fy.astype(jnp.int32)
    k = fz.astype(jnp.int32)

    # Hermite smoothing u*u*(3-2u) (perlin.h:80-82).
    uu = u * u * (3.0 - 2.0 * u)
    vv = v * v * (3.0 - 2.0 * v)
    ww = w * w * (3.0 - 2.0 * w)

    perm = scene.per_perm  # [Q,3,256]
    Q = perm.shape[0]
    K = Q * PERLIN_N
    rx = scene.per_ranvec[..., 0].reshape(-1)  # [Q*256]
    ry = scene.per_ranvec[..., 1].reshape(-1)
    rz = scene.per_ranvec[..., 2].reshape(-1)
    base = pid * PERLIN_N

    # Lattice permutation reads: one Lookup per axis serves both the +0 and
    # +1 neighbor — the neighbor's value is the same one-hot applied to the
    # within-block-rolled table (roll of a [Q,256] table is free; the
    # (i+1)&255 wraparound IS the block-circular roll).
    perm_roll = jnp.roll(perm, -1, axis=2)
    pv = []  # pv[axis] = (value at +0, value at +1), each [B] int32
    for axis, iv in ((0, i), (1, j), (2, k)):
        look = Lookup(base + (iv & (PERLIN_N - 1)), K)
        p0, p1 = look(perm[:, axis, :].reshape(-1),
                      perm_roll[:, axis, :].reshape(-1))
        pv.append((p0, p1))

    accum = jnp.zeros_like(p.x)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                gidx = pv[0][di] ^ pv[1][dj] ^ pv[2][dk]
                g = Lookup(base + gidx, K).v3(
                    jnp.stack([rx, ry, rz], axis=1))
                weight_v = V3(u - di, v - dj, w - dk)
                wgt = (
                    (di * uu + (1 - di) * (1.0 - uu))
                    * (dj * vv + (1 - dj) * (1.0 - vv))
                    * (dk * ww + (1 - dk) * (1.0 - ww))
                )
                accum = accum + wgt * vec3.dot(g, weight_v)
    return accum


def perlin_turb(scene, perlin_ids, p: V3, depth: int = 7):
    """7-octave fBm |accum| (perlin.h:42-54) — part of the reference API
    surface (unused by the stock noise_texture but kept for parity)."""
    accum = jnp.zeros_like(p.x)
    weight = 1.0
    q = p
    for _ in range(depth):
        accum = accum + weight * perlin_noise(scene, perlin_ids, q)
        weight *= 0.5
        q = q * 2.0
    return jnp.abs(accum)


# --------------------------------------------------------------------------
# Texture evaluation
# --------------------------------------------------------------------------


def texture_value(scene, tex_ids, u, v, tu, tv, p: V3,
                  fast_texel: bool = False) -> V3:
    """Evaluate the texture table for a batch.

    (u, v) are the raw surface parameters (barycentric for triangles) feeding
    TEX_BARYCENTRIC; (tu, tv) are the image-sampling coordinates — for
    triangles the barycentric blend of vertex texcoords (the reference's
    barycentric_image_texture, texture.h:135-154), identical to (u, v) for
    every other primitive.

    ``fast_texel``: forward-only renders set this to fetch image texels
    through the packed 8:8:8 atlas (one scalar gather, bit-identical — the
    build validated it) instead of the 3-wide row gather.  MUST stay False
    on the differentiable path: the packed unpack is floor arithmetic, so
    texel gradients only flow through the row gather.
    """
    tid = jnp.clip(tex_ids, 0, scene.tex_kind.shape[0] - 1)
    look = Lookup(tid, scene.tex_kind.shape[0])
    (kind,) = look(scene.tex_kind)
    ca = look.v3(scene.tex_ca)

    out = ca  # TEX_SOLID

    # Static kind-presence gating: only compile the texture models the scene
    # actually contains (scene.tex_kinds is static metadata).
    kinds = scene.tex_kinds or tuple(range(5))

    if scene_lib.TEX_CHECKER in kinds:
        # Checker: sign of sin(10x)sin(10y)sin(10z) (texture.h:39-45).
        cb = look.v3(scene.tex_cb)
        sines = jnp.sin(10.0 * p.x) * jnp.sin(10.0 * p.y) * jnp.sin(10.0 * p.z)
        out = vec3.where(
            (kind == scene_lib.TEX_CHECKER) & (sines < 0.0), cb, out
        )

    if scene_lib.TEX_NOISE in kinds:
        # Perlin: 0.5*(1+noise(scale*p)) grayscale (texture.h:57-59).
        (scale, aux) = look(scene.tex_scale, scene.tex_aux)
        noise = perlin_noise(scene, aux, p * scale)
        gray = 0.5 * (1.0 + noise)
        out = vec3.where(kind == scene_lib.TEX_NOISE, V3(gray, gray, gray), out)

    if scene_lib.TEX_IMAGE in kinds:
        # Image: clamp u, flip v, nearest texel (texture.h:88-111).
        (aux_img,) = look(scene.tex_aux)
        img = jnp.clip(aux_img, 0, scene.img_off.shape[0] - 1)
        ilook = Lookup(img, scene.img_off.shape[0])
        (w, h, off) = ilook(scene.img_w, scene.img_h, scene.img_off)
        cu = jnp.clip(tu, 0.0, 1.0)
        cv = 1.0 - jnp.clip(tv, 0.0, 1.0)
        i = jnp.minimum((cu * w.astype(p.x.dtype)).astype(jnp.int32), w - 1)
        j = jnp.minimum((cv * h.astype(p.x.dtype)).astype(jnp.int32), h - 1)
        if fast_texel and scene.atlas_exact_u8:
            # ONE scalar gather of the packed 8:8:8 texel + exact f32
            # floor-unpack (values < 2^24; k/255 is a single correctly-
            # rounded divide, bit-equal to the stored atlas value per the
            # build-time check).  A third of the row gather's elements.
            pidx = off + j * w + i
            if ATLAS_IDX_ZERO:
                # Lanes whose winner is NOT the image texture discard the
                # texel anyway (the kind select below).
                pidx = jnp.where(kind == scene_lib.TEX_IMAGE, pidx, 0)
            if ATLAS_BARRIER:
                (pidx,) = jax.lax.optimization_barrier((pidx,))
            B = pidx.shape[0]
            if ATLAS_COMPACT and B >= ATLAS_COMPACT_MIN_B:
                cap = B // ATLAS_COMPACT_DIV
                is_img = kind == scene_lib.TEX_IMAGE
                csum = jnp.cumsum(is_img.astype(jnp.int32))
                count = csum[-1]

                def compact(_):
                    ranks = jnp.arange(1, cap + 1, dtype=jnp.int32)
                    src = jnp.searchsorted(csum, ranks, side="left")
                    valid = ranks <= count
                    srcc = jnp.minimum(src, B - 1)
                    texel = scene.atlas_packed[pidx[srcc]]
                    # distinct out-of-bounds sentinels for dropped lanes
                    # (unique_indices contract, see integrator scatter-back)
                    dst = jnp.where(valid, srcc, B + ranks)
                    return jnp.zeros((B,), texel.dtype).at[dst].set(
                        texel, mode="drop", unique_indices=True)

                def full(_):
                    return scene.atlas_packed[pidx]

                pk = jax.lax.cond(count <= cap, compact, full, None)
            else:
                pk = scene.atlas_packed[pidx]
            if ATLAS_BARRIER:
                (pk,) = jax.lax.optimization_barrier((pk,))
            r = jnp.floor(pk * (1.0 / 65536.0))
            gb = pk - r * 65536.0
            g = jnp.floor(gb * (1.0 / 256.0))
            bl = gb - g * 256.0
            texel = V3(r / 255.0, g / 255.0, bl / 255.0)
        else:
            # One [B]-indexed ROW gather instead of three column gathers
            # that share the texel index.
            rows = scene.atlas[off + j * w + i]
            texel = V3(rows[:, 0], rows[:, 1], rows[:, 2])
        out = vec3.where(kind == scene_lib.TEX_IMAGE, texel, out)

    if scene_lib.TEX_BARYCENTRIC in kinds:
        # Barycentric color blend u*A + v*B + (1-u-v)*C (texture.h:121-133).
        cb = look.v3(scene.tex_cb)
        cc = look.v3(scene.tex_cc)
        bary = ca * u + cb * v + cc * (1.0 - u - v)
        out = vec3.where(kind == scene_lib.TEX_BARYCENTRIC, bary, out)
    return out


# --------------------------------------------------------------------------
# Emission + scatter
# --------------------------------------------------------------------------


def emitted(scene, rec: HitRecord, fast_texel: bool = False) -> V3:
    """diffuse_light emits its texture; everything else black
    (material.h:12-14, 112-114)."""
    zero = jnp.zeros_like(rec.u)
    if scene.mat_kinds and scene_lib.MAT_DIFFUSE_LIGHT not in scene.mat_kinds:
        return V3(zero, zero, zero)
    look = Lookup(rec.mat, scene.mat_kind.shape[0])
    (kind, tex) = look(scene.mat_kind, scene.mat_tex)
    emit = texture_value(scene, tex, rec.u, rec.v, rec.tu, rec.tv, rec.p,
                         fast_texel)
    return vec3.where(kind == scene_lib.MAT_DIFFUSE_LIGHT, emit, V3(zero, zero, zero))


def scatter(scene, rec: HitRecord, d_in: V3, pixel_ids, sample_ids, bounce,
            seed, fast_texel: bool = False):
    """Branchless scatter for a batch of hits.

    Returns (scatter_dir V3 — NOT normalized, matching the reference's
    un-normalized scattered rays; attenuation V3; scatter_ok [B]).

    ``want_emit=False`` keeps this arm honest for the FUSE_SHADE A/B: the
    emission select is skipped entirely, so the unfused path pays exactly
    (separate emitted) + (scatter without emission), not fused + emitted.
    """
    _, direction, attenuation, ok = emit_and_scatter(
        scene, rec, d_in, pixel_ids, sample_ids, bounce, seed, fast_texel,
        want_emit=False,
    )
    return direction, attenuation, ok


def emit_and_scatter(scene, rec: HitRecord, d_in: V3, pixel_ids, sample_ids,
                     bounce, seed, fast_texel: bool = False,
                     want_emit: bool = True):
    """Fused ``emitted`` + ``scatter`` for one bounce.

    The reference evaluates ``mat->emitted`` then ``mat->scatter`` on the
    same hit record (engine.h:460-465); both read the material's single
    texture (emission for diffuse_light, albedo for everything else), so one
    material-table Lookup and one texture evaluation serve both — half the
    per-bounce table/texture work of calling them separately.

    Returns (emit V3, scatter_dir V3 — NOT normalized, matching the
    reference's un-normalized scattered rays; attenuation V3; scatter_ok [B]).
    """
    look = Lookup(rec.mat, scene.mat_kind.shape[0])
    (kind, tex, fuzz, ir) = look(
        scene.mat_kind, scene.mat_tex, scene.mat_fuzz, scene.mat_ir
    )
    n = rec.normal
    kinds = scene.mat_kinds or tuple(range(5))

    u1, u2 = rng.uniform2(seed, pixel_ids, sample_ids, bounce, rng.DIM_SCATTER_A)

    rand_unit = vec3.unit_vector_from_uniforms(u1, u2)
    need_sphere = (scene_lib.MAT_METAL in kinds) or (scene_lib.MAT_ISOTROPIC in kinds)
    need_unit_d = (scene_lib.MAT_METAL in kinds) or (scene_lib.MAT_DIELECTRIC in kinds)
    # Lanes 2,3 feed only the unit-ball radius (metal fuzz / isotropic) and
    # the dielectric reflectance coin; a lambertian/light-only scene (e.g.
    # the Cornell box) skips that threefry block entirely.  Lane assignments
    # are fixed per purpose, so gating never shifts other draws.
    if need_sphere or (scene_lib.MAT_DIELECTRIC in kinds):
        u3, u4 = rng.uniform2(seed, pixel_ids, sample_ids, bounce, rng.DIM_SCATTER_B)
    rand_in_sphere = rand_unit * jnp.cbrt(u3) if need_sphere else rand_unit
    unit_d = vec3.unit(d_in) if need_unit_d else d_in

    # lambertian (material.h:29-36)
    lam_dir = n + rand_unit
    lam_dir = vec3.where(vec3.near_zero(lam_dir), n, lam_dir)
    direction = lam_dir
    ok = jnp.ones(u1.shape, bool)

    if scene_lib.MAT_METAL in kinds:
        # metal (material.h:52-55)
        met_dir = vec3.reflect(unit_d, n) + rand_in_sphere * fuzz
        met_ok = vec3.dot(met_dir, n) > 0.0
        direction = vec3.where(kind == scene_lib.MAT_METAL, met_dir, direction)
        ok = jnp.where(kind == scene_lib.MAT_METAL, met_ok, ok)

    if scene_lib.MAT_DIELECTRIC in kinds:
        # dielectric (material.h:70-99)
        ratio = jnp.where(rec.front_face, 1.0 / ir, ir)
        cos_theta = jnp.minimum(vec3.dot(-unit_d, n), 1.0)
        # 1e-12 floor: finite grad at grazing incidence (see vec3.refract).
        sin_theta = jnp.sqrt(jnp.maximum(1e-12, 1.0 - cos_theta * cos_theta))
        cannot_refract = ratio * sin_theta > 1.0
        r0 = (1.0 - ratio) / (1.0 + ratio)
        r0 = r0 * r0
        reflectance = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
        reflect_dir = vec3.reflect(unit_d, n)
        refract_dir = vec3.refract(unit_d, n, ratio)
        die_reflect = cannot_refract | (reflectance > u4)
        die_dir = vec3.where(die_reflect, reflect_dir, refract_dir)
        direction = vec3.where(kind == scene_lib.MAT_DIELECTRIC, die_dir, direction)

    if scene_lib.MAT_ISOTROPIC in kinds:
        direction = vec3.where(kind == scene_lib.MAT_ISOTROPIC, rand_in_sphere, direction)

    tex_val = texture_value(scene, tex, rec.u, rec.v, rec.tu, rec.tv, rec.p,
                            fast_texel)
    attenuation = tex_val
    if scene_lib.MAT_DIELECTRIC in kinds:
        one = jnp.ones_like(u1)
        attenuation = vec3.where(
            kind == scene_lib.MAT_DIELECTRIC, V3(one, one, one), attenuation
        )
    zero = jnp.zeros_like(u1)
    emit = V3(zero, zero, zero)
    if scene_lib.MAT_DIFFUSE_LIGHT in kinds:
        ok = jnp.where(kind == scene_lib.MAT_DIFFUSE_LIGHT, False, ok)
        if want_emit:
            # diffuse_light emits its texture (material.h:112-114).
            emit = vec3.where(kind == scene_lib.MAT_DIFFUSE_LIGHT, tex_val, emit)
    return emit, direction, attenuation, ok
