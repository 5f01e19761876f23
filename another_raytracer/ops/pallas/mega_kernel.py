"""Pallas megakernel (Triton route): the ENTIRE forward wavefront in one kernel.

The XLA forward path (ops/integrator.trace_regenerative) is a while_loop
whose body is many separate fusions; every piece of ray state makes a round
trip through device memory between them, and each fusion is its own launch
over the whole ray batch for every iteration.  This kernel is the standard
GPU path-tracer design for sweep-regime scenes instead: one ray per thread,
its state held in registers (loop carries), and the whole
regenerating path-trace loop run to completion inside the kernel —

  * camera ray generation (engine.h:58-68 + camera.h:38-47),
  * counter-based threefry draws (ops/rng.py — the same code, called
    inside the kernel on uint32 lanes),
  * the closest-hit sweep over all primitives (spheres first, then rects,
    matching ops/intersect.closest_hit's fold order), reading the <= 64-row
    primitive table one row per loop step with uniform scalar loads,
  * branchless material shading + scatter (material.h contracts, mirroring
    ops/shade.emit_and_scatter),
  * per-lane sample regeneration (ops/integrator._regen_loop_parts.body).

A block of rays only returns to device memory when its lanes exhaust their
samples, and its trip count is the max over the block's lanes rather than
over the whole batch.

Loop structure: Triton's compiler crashes on a reduction inside an
scf.while (found on the H100 with the installed JAX), so the kernel has no
while_loop.  A static-bound fori_loop (the most iterations any lane can need:
samples per lane x max_depth) runs ALIVE_CHECK_EVERY bounce steps at a time
inside a cond on "any lane of the block still alive"; once the block is
done, each remaining outer step costs one block reduction.

Geometry is pre-baked into world space per primitive row so the kernel does
no per-ray transform work:

  * spheres: world centers (a rigid transform maps a sphere to a sphere and
    commutes with the center lerp — same baking as models/bvh.pack_spheres);
  * rects: world parallelograms (q0 corner, edge vectors eu/ev, unit normal
    n, plane offset d0 = n.q0): t = (d0 - n.o)/(n.d), then
    0 <= (p-q0).eu <= |eu|^2 (and v alike) reproduces aarect.cpp's
    inclusive bound check; for identity transforms the arithmetic reduces
    exactly to the axis-aligned sweep's (0*x terms vanish exactly in f32).

Applicability (static, ``supports()``): sweep-only scenes (no BVH, no
media, no triangles), materials within {lambertian, metal, dielectric,
diffuse_light}, textures within {solid, checker}.  That covers the Cornell
box, sphere-ground and two-spheres scenes; BVH'd and textured scenes keep
the XLA wavefront.

Numerics: the same f32 formulas as the XLA path, but the GPU's
transcendental lowerings (sin/cos/sqrt/cbrt) and fma contraction differ at
ulp level, so images agree to tolerance rather than bit-exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from another_raytracer.models import scene as scene_lib
from another_raytracer.ops import rng
from another_raytracer.ops.vec3 import V3

BIG = 3e37
# Rays per Pallas block, one per thread (block // 32 warps).  A power of two
# in [32, 1024].  On the H100 smaller blocks win (a block's trip count is
# the max over its lanes): the sweep that chose 32 is in PERF.md.
DEFAULT_BLOCK = 32
NEAR_ZERO_EPS = 1e-8  # vec3.h:51
# Bounce steps per alive check (the reduction over the block).
ALIVE_CHECK_EVERY = 4

# Columns per primitive row (flattened [N * ROW_W] f32 table).
ROW_W = 32
MAX_ROWS = 64
# Shared material slots (identical for both primitive kinds).
_C_MKIND, _C_FUZZ, _C_IR, _C_TKIND = 16, 17, 18, 19
_C_CA, _C_CB = 20, 23
_C_TID = 26  # texture id (exact in f32) — folded only when recording codes


def _shading_ok(scene) -> bool:
    return (
        scene.n_media == 0
        and scene.n_triangles == 0
        and set(scene.mat_kinds) <= {
            scene_lib.MAT_LAMBERTIAN, scene_lib.MAT_METAL,
            scene_lib.MAT_DIELECTRIC, scene_lib.MAT_DIFFUSE_LIGHT}
        and set(scene.tex_kinds) <= {scene_lib.TEX_SOLID,
                                     scene_lib.TEX_CHECKER}
    )


def supports(scene, cam) -> bool:
    """Static applicability check (all fields non-pytree)."""
    return (
        not scene.has_accel
        and 0 < (scene.n_spheres + scene.n_rects) <= MAX_ROWS
        and _shading_ok(scene)
    )


def enabled(scene, cam) -> bool:
    """The one place the forward megakernel is chosen: on the GPU, for
    scenes it supports.  Other backends run the XLA wavefront; the Pallas
    interpreter is only ever used by callers that ask for it."""
    return jax.default_backend() == "gpu" and supports(scene, cam)


def lane_struct(shape, dtype, like):
    """ShapeDtypeStruct carrying ``like``'s varying-axes type: under
    shard_map(check_vma=True) pallas_call outputs must declare their vma."""
    vma = getattr(jax.typeof(like), "vma", None)
    if vma:
        return jax.ShapeDtypeStruct(shape, dtype, vma=vma)
    return jax.ShapeDtypeStruct(shape, dtype)


def match_vma(like, *arrays):
    """Promote replicated operands to ``like``'s varying-axes type with
    lax.pvary: under shard_map(check_vma=True) a Pallas kernel's body mixes
    block operands freely, so every input must enter uniformly varying
    (replicated scene tables meet device-varying rays here)."""
    vma = getattr(jax.typeof(like), "vma", None)
    if not vma:
        return arrays
    out = []
    for a in arrays:
        need = tuple(vma - getattr(jax.typeof(a), "vma", frozenset()))
        out.append(jax.lax.pvary(a, need) if need else a)
    return tuple(out)


def _pad_pow2(a, fill=0):
    """Pad a 1-D table to a power-of-two length (Triton block shapes)."""
    n = a.shape[0]
    target = 1 << max(n - 1, 0).bit_length()
    return jnp.pad(a, (0, target - n), constant_values=fill) if target > n else a


# --------------------------------------------------------------------------
# Row packing (traced jnp — scene arrays may be tracers under jit)
# --------------------------------------------------------------------------


def _onehot3(axis):
    """[N] int axis -> [N,3] f32 one-hot (exact 0/1)."""
    return (axis[:, None] == jnp.arange(3, dtype=axis.dtype)[None, :]).astype(
        jnp.float32)


def _rotate(rot, v):
    """[N,3,3] @ [N,3] as elementwise products and sums: exact f32, never a
    dot that the GPU could run in TF32."""
    return jnp.sum(rot * v[:, None, :], axis=2)


def _mat_cols(scene, mat_ids):
    """Per-primitive baked material/texture scalars -> [N, 16] (cols 16..31)."""
    mk = scene.mat_kind[mat_ids].astype(jnp.float32)
    fuzz = scene.mat_fuzz[mat_ids]
    ir = scene.mat_ir[mat_ids]
    tex = scene.mat_tex[mat_ids]
    tk = scene.tex_kind[tex].astype(jnp.float32)
    ca = scene.tex_ca[tex]
    cb = scene.tex_cb[tex]
    tid = tex.astype(jnp.float32)
    pad = jnp.zeros((mat_ids.shape[0], ROW_W - _C_TID - 1), jnp.float32)
    return jnp.concatenate(
        [mk[:, None], fuzz[:, None], ir[:, None], tk[:, None], ca, cb,
         tid[:, None], pad],
        axis=1)


def pack_rows(scene):
    """[ (Ns+Nr) * ROW_W ] flat f32 row table; spheres first, then rects —
    the fold order of ops/intersect.closest_hit (strict improvement keeps
    the earlier row on ties, like argmin's first-min-index)."""
    parts = []
    if scene.n_spheres:
        rot = scene.xf_rot[scene.sph_xf]
        tr = scene.xf_trans[scene.sph_xf]
        c0w = _rotate(rot, scene.sph_c0) + tr
        c1w = _rotate(rot, scene.sph_c1) + tr
        dt = scene.sph_t1 - scene.sph_t0
        inv_dt = jnp.where(dt != 0.0, 1.0 / jnp.where(dt != 0.0, dt, 1.0), 0.0)
        pad1 = jnp.zeros((scene.n_spheres, 1), jnp.float32)
        geom = jnp.concatenate(
            [pad1, c0w, c1w - c0w, scene.sph_t0[:, None], inv_dt[:, None],
             scene.sph_r[:, None],
             jnp.zeros((scene.n_spheres, _C_MKIND - 10), jnp.float32)], axis=1)
        parts.append(jnp.concatenate(
            [geom, _mat_cols(scene, scene.sph_mat)], axis=1))
    if scene.n_rects:
        axis = scene.rect_axis
        au = jnp.where(axis == 0, 1, 0)
        av = jnp.where(axis == 2, 1, 2)
        lo, hi = scene.rect_lo, scene.rect_hi
        q0_obj = (_onehot3(axis) * scene.rect_k[:, None]
                  + _onehot3(au) * lo[:, 0:1] + _onehot3(av) * lo[:, 1:2])
        eu_obj = _onehot3(au) * (hi[:, 0:1] - lo[:, 0:1])
        ev_obj = _onehot3(av) * (hi[:, 1:2] - lo[:, 1:2])
        n_obj = _onehot3(axis)
        rot = scene.xf_rot[scene.rect_xf]
        tr = scene.xf_trans[scene.rect_xf]
        q0 = _rotate(rot, q0_obj) + tr
        eu = _rotate(rot, eu_obj)
        ev = _rotate(rot, ev_obj)
        nw = _rotate(rot, n_obj)
        d0 = jnp.sum(nw * q0, axis=1, keepdims=True)
        # Exact object-space edge lengths squared (rotation-free, so the
        # identity-transform case reproduces the sweep's bound arithmetic).
        l2u = ((hi[:, 0] - lo[:, 0]) ** 2)[:, None]
        l2v = ((hi[:, 1] - lo[:, 1]) ** 2)[:, None]
        pad1 = jnp.zeros((scene.n_rects, 1), jnp.float32)
        geom = jnp.concatenate([pad1, q0, eu, ev, nw, d0, l2u, l2v], axis=1)
        parts.append(jnp.concatenate(
            [geom, _mat_cols(scene, scene.rect_mat)], axis=1))
    return jnp.concatenate(parts, axis=0).reshape(-1)


# --------------------------------------------------------------------------
# Kernel
# --------------------------------------------------------------------------


def _kernel(uic_ref, camc_ref, rows_ref, pix_ref, fi_ref, fj_ref, samp_ref,
            out_tx, out_ty, out_tz, out_seg, *rec_refs,
            n_spheres, n_rects, mat_kinds, tex_kinds, has_lens, has_time,
            max_depth, t_min, width, height, record_rows, n_textures,
            n_outer):
    # Optional residual-recording outputs (the differentiable fused path,
    # ops/pallas/mega_diff.py), each [record_rows, B] in device memory: per
    # bounce step one int32 code row — code = tex_id*16 +
    # checker_odd*8 + chain_end*4 + event with event 0=dead, 1=scatter,
    # 2=light-hit, 3=miss — and the three channels of the iteration-ENTRY
    # throughput T_prev, which the replay backward needs.
    if record_rows:
        out_code, out_tpx, out_tpy, out_tpz = rec_refs
    # np scalars, NOT jnp: jnp constants built outside the traced body would
    # be captured-constant arrays, which pallas_call rejects.
    f32 = np.float32
    u32 = np.uint32

    def c3(base):
        return (camc_ref[base], camc_ref[base + 1], camc_ref[base + 2])

    cam_o = c3(0)
    cam_base = c3(3)
    cam_h = c3(6)
    cam_v = c3(9)
    cam_u = c3(12)
    cam_w = c3(15)
    lens_radius = camc_ref[18]
    time0 = camc_ref[19]
    time_del = camc_ref[20]
    bg = c3(21)

    seed = uic_ref[0]
    limit = uic_ref[1]
    stride = uic_ref[2]

    fi = fi_ref[...]
    fj = fj_ref[...]
    pix = pix_ref[...]

    inv_w1 = f32(1.0 / (width - 1))
    inv_h1 = f32(1.0 / (height - 1))
    h1 = f32(height - 1)
    two_pi = f32(6.2831853071795864769)

    has_metal = scene_lib.MAT_METAL in mat_kinds
    has_diel = scene_lib.MAT_DIELECTRIC in mat_kinds
    has_light = scene_lib.MAT_DIFFUSE_LIGHT in mat_kinds
    has_checker = scene_lib.TEX_CHECKER in tex_kinds
    need_sphere_draw = has_metal  # isotropic excluded by supports()
    need_unit_d = has_metal or has_diel
    need_b_draw = need_sphere_draw or has_diel

    def uniform2(sample, bounce, dim):
        """ops/rng.uniform2 inline: key (seed, bounce<<8|dim), ctr (pix, s)."""
        k1 = (bounce << u32(8)) | u32(dim)
        b0, b1 = rng.threefry2x32(seed, k1, pix, sample, rounds=rng.ROUNDS)
        return rng._uniform_from_bits(b0), rng._uniform_from_bits(b1)

    def cam_rays(sample):
        """camera.generate_rays inline (engine.h:58-68, camera.h:38-47)."""
        cb = u32(rng.CAMERA_BOUNCE)
        ju, jv = uniform2(sample, cb, rng.DIM_PIXEL_JITTER)
        s = (fi + ju) * inv_w1
        t = (h1 - fj + jv) * inv_h1
        if has_lens:
            lu, lv = uniform2(sample, cb, rng.DIM_LENS)
            rr = jnp.sqrt(lu)
            phi = two_pi * lv
            rdx = lens_radius * (rr * jnp.cos(phi))
            rdy = lens_radius * (rr * jnp.sin(phi))
            offs = tuple(cam_u[c] * rdx + cam_w[c] * rdy for c in range(3))
            o = tuple(offs[c] + cam_o[c] for c in range(3))
            d = tuple(cam_base[c] + cam_h[c] * s + cam_v[c] * t - offs[c]
                      for c in range(3))
        else:
            o = tuple(cam_o[c] + s * 0.0 for c in range(3))
            d = tuple(cam_base[c] + cam_h[c] * s + cam_v[c] * t
                      for c in range(3))
        if has_time:
            tu, _ = uniform2(sample, cb, rng.DIM_TIME)
            tmv = time0 + tu * time_del
        else:
            tmv = time0 + s * 0.0
        return o, d, tmv

    # Closest-hit fold state: which per-row fields the shading needs.
    fold_cols = {"mk": _C_MKIND, "ca0": _C_CA, "ca1": _C_CA + 1,
                 "ca2": _C_CA + 2}
    if has_checker:
        fold_cols.update(cb0=_C_CB, cb1=_C_CB + 1, cb2=_C_CB + 2,
                         tk=_C_TKIND)
    if has_metal:
        fold_cols["fz"] = _C_FUZZ
    if has_diel:
        fold_cols["ir"] = _C_IR
    if record_rows:
        fold_cols["tid"] = _C_TID

    def fold(st, valid, t, n, row):
        new = dict(t=t, nx=n[0], ny=n[1], nz=n[2])
        new.update({k: row(c) for k, c in fold_cols.items()})
        return {k: jnp.where(valid, new[k], v) for k, v in st.items()}

    def row_reader(j):
        base = j * ROW_W
        return lambda c: rows_ref[base + c]

    def sweep(o, d, tmv, a_len, z):
        st = {k: z for k in ("nx", "ny", "nz", *fold_cols)}
        st["t"] = z + f32(BIG)
        if n_spheres:
            inv_a = 1.0 / jnp.where(a_len > 0.0, a_len, 1.0)

            def sphere(j, st):
                r = row_reader(j)
                # sphere.h:39-65 / moving_sphere.h:29-31 on world-baked
                # centers.
                frac = (tmv - r(7)) * r(8)
                cx = r(1) + frac * r(4)
                cy = r(2) + frac * r(5)
                cz = r(3) + frac * r(6)
                rad = r(9)
                ocx = o[0] - cx
                ocy = o[1] - cy
                ocz = o[2] - cz
                half_b = ocx * d[0] + ocy * d[1] + ocz * d[2]
                c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
                disc = half_b * half_b - a_len * c
                ok = disc > 0.0
                sq = jnp.sqrt(jnp.where(ok, disc, 0.0))
                best_t = st["t"]
                root1 = (-half_b - sq) * inv_a
                r1_ok = (root1 > t_min) & (root1 < best_t)
                t = jnp.where(r1_ok, root1, (-half_b + sq) * inv_a)
                valid = ok & (t > t_min) & (t < best_t)
                inv_r = 1.0 / rad
                n = ((o[0] + t * d[0] - cx) * inv_r,
                     (o[1] + t * d[1] - cy) * inv_r,
                     (o[2] + t * d[2] - cz) * inv_r)
                return fold(st, valid, t, n, r)

            st = jax.lax.fori_loop(0, n_spheres, sphere, st)
        if n_rects:
            def rect(j, st):
                r = row_reader(j)
                # World parallelogram == aarect.cpp plane + inclusive bounds.
                n = (r(10), r(11), r(12))
                ndotd = n[0] * d[0] + n[1] * d[1] + n[2] * d[2]
                ndoto = n[0] * o[0] + n[1] * o[1] + n[2] * o[2]
                ok = ndotd != 0.0
                t = jnp.where(ok, (r(13) - ndoto) / jnp.where(ok, ndotd, 1.0),
                              f32(BIG))
                rx = o[0] + t * d[0] - r(1)
                ry = o[1] + t * d[1] - r(2)
                rz = o[2] + t * d[2] - r(3)
                a = rx * r(4) + ry * r(5) + rz * r(6)
                b = rx * r(7) + ry * r(8) + rz * r(9)
                inside = (a >= 0.0) & (a <= r(14)) & (b >= 0.0) & (b <= r(15))
                valid = ok & inside & (t > t_min) & (t < st["t"])
                return fold(st, valid, t, (n[0] + z, n[1] + z, n[2] + z), r)

            st = jax.lax.fori_loop(n_spheres, n_spheres + n_rects, rect, st)
        return st

    def body(carry):
        (it, o, d, tmv, tp, path, total, sample, bounce, alive_i,
         seg) = carry
        alive = alive_i > 0
        tp_entry = tp
        z = tmv * 0.0
        a_len = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        st = sweep(o, d, tmv, a_len, z)
        best_t = st["t"]
        b_n = (st["nx"], st["ny"], st["nz"])
        b_mk = st["mk"]

        hit = alive & (best_t < f32(BIG))
        miss_now = alive & ~hit

        # ---- shade + scatter (shade.emit_and_scatter) ---------------------
        # set_face_normal (hittable.h:18-22)
        ndd = b_n[0] * d[0] + b_n[1] * d[1] + b_n[2] * d[2]
        front = ndd < 0.0
        n = tuple(jnp.where(front, b_n[c], -b_n[c]) for c in range(3))
        p = tuple(o[c] + best_t * d[c] for c in range(3))

        # texture value (texture.h:39-45 checker / solid)
        alb = (st["ca0"], st["ca1"], st["ca2"])
        if has_checker:
            sines = (jnp.sin(10.0 * p[0]) * jnp.sin(10.0 * p[1])
                     * jnp.sin(10.0 * p[2]))
            is_check = (st["tk"] == f32(scene_lib.TEX_CHECKER)) & (sines < 0.0)
            b_cb = (st["cb0"], st["cb1"], st["cb2"])
            alb = tuple(jnp.where(is_check, b_cb[c], alb[c]) for c in range(3))

        u1, u2 = uniform2(sample, bounce, rng.DIM_SCATTER_A)
        zz = 1.0 - 2.0 * u1
        rr = jnp.sqrt(jnp.maximum(0.0, 1.0 - zz * zz))
        phi = two_pi * u2
        rand_unit = (rr * jnp.cos(phi), rr * jnp.sin(phi), zz)
        if need_b_draw:
            u3, u4 = uniform2(sample, bounce, rng.DIM_SCATTER_B)
        if need_sphere_draw:
            cr = jnp.cbrt(u3)
            rand_sph = tuple(rand_unit[c] * cr for c in range(3))
        if need_unit_d:
            inv_len = jax.lax.rsqrt(jnp.where(a_len > 0.0, a_len, 1.0))
            unit_d = tuple(d[c] * inv_len for c in range(3))

        # lambertian (material.h:29-36)
        lam = tuple(n[c] + rand_unit[c] for c in range(3))
        lam_nz = ((jnp.abs(lam[0]) < NEAR_ZERO_EPS)
                  & (jnp.abs(lam[1]) < NEAR_ZERO_EPS)
                  & (jnp.abs(lam[2]) < NEAR_ZERO_EPS))
        new_d = tuple(jnp.where(lam_nz, n[c], lam[c]) for c in range(3))
        ok = hit

        if has_metal:
            is_met = b_mk == f32(scene_lib.MAT_METAL)
            uddn = (unit_d[0] * n[0] + unit_d[1] * n[1] + unit_d[2] * n[2])
            met = tuple(unit_d[c] - n[c] * (2.0 * uddn)
                        + rand_sph[c] * st["fz"] for c in range(3))
            met_ok = met[0] * n[0] + met[1] * n[1] + met[2] * n[2] > 0.0
            new_d = tuple(jnp.where(is_met, met[c], new_d[c]) for c in range(3))
            ok = (ok & ~is_met) | (is_met & hit & met_ok)

        if has_diel:
            is_die = b_mk == f32(scene_lib.MAT_DIELECTRIC)
            b_ir = st["ir"]
            ratio = jnp.where(front, 1.0 / b_ir, b_ir)
            uddn = (unit_d[0] * n[0] + unit_d[1] * n[1] + unit_d[2] * n[2])
            cos_t = jnp.minimum(-uddn, 1.0)
            sin_t = jnp.sqrt(jnp.maximum(1e-12, 1.0 - cos_t * cos_t))
            cannot = ratio * sin_t > 1.0
            r0 = (1.0 - ratio) / (1.0 + ratio)
            r0 = r0 * r0
            refl = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
            rfl = tuple(unit_d[c] - n[c] * (2.0 * uddn) for c in range(3))
            # vec3.refract with the same 1e-12 TIR floor
            perp = tuple((unit_d[c] + n[c] * cos_t) * ratio for c in range(3))
            p2 = perp[0] ** 2 + perp[1] ** 2 + perp[2] ** 2
            par = -jnp.sqrt(jnp.maximum(jnp.abs(1.0 - p2), 1e-12))
            rfr = tuple(perp[c] + n[c] * par for c in range(3))
            die_refl = cannot | (refl > u4)
            die = tuple(jnp.where(die_refl, rfl[c], rfr[c]) for c in range(3))
            new_d = tuple(jnp.where(is_die, die[c], new_d[c]) for c in range(3))

        att = alb
        if has_diel:
            att = tuple(jnp.where(is_die, 1.0, att[c]) for c in range(3))
        if has_light:
            is_light = b_mk == f32(scene_lib.MAT_DIFFUSE_LIGHT)
            ok = ok & ~is_light
            emit = tuple(jnp.where(is_light, alb[c], 0.0) for c in range(3))

        # ---- radiance / carry updates (integrator._advance + regen body) --
        delta = [jnp.where(miss_now, tp[c] * bg[c], 0.0) for c in range(3)]
        if has_light:
            for c in range(3):
                delta[c] = delta[c] + jnp.where(hit, tp[c] * emit[c], 0.0)
        scattered = hit & ok
        path = tuple(path[c] + delta[c] for c in range(3))
        tp = tuple(jnp.where(scattered, tp[c] * att[c], tp[c])
                   for c in range(3))
        o = tuple(jnp.where(scattered, p[c], o[c]) for c in range(3))
        d = tuple(jnp.where(scattered, new_d[c], d[c]) for c in range(3))
        bounce = jnp.where(alive, bounce + u32(1), bounce)
        alive_next = scattered & (bounce < u32(max_depth))
        seg = seg + scattered.astype(jnp.int32)

        ended = alive & ~alive_next
        if record_rows:
            # Residual code row for the fused differentiable path:
            # tid*16 + checker_odd*8 + chain_end*4 + event.
            ev = scattered.astype(jnp.int32) + jnp.where(miss_now, 3, 0)
            if has_light:
                ev = ev + jnp.where(hit & is_light, 2, 0)
            tid = st["tid"].astype(jnp.int32)
            if has_diel:
                # Dielectric attenuation is the constant (1,1,1)
                # (material.h:77-79): record the sentinel tid n_textures so
                # the replay multiplies by 1 and routes no albedo cotangent.
                tid = jnp.where(is_die, n_textures, tid)
            tid16 = jnp.where(ev > 0, tid * 16, 0)
            code = tid16 + jnp.where(ended, 4, 0) + ev
            if has_checker:
                # which checker branch won: the replay routes the albedo
                # cotangent to tex_cb for odd cells
                code = code + jnp.where(is_check, 8, 0)
            # Metal absorption (scatter below the surface, material.h:52-55)
            # emits ev=0 WITH the end bit: the replay zeroes the suffix
            # value there (the chain dies contributing nothing).
            # it < record_rows always: the rows cover the static trip bound.
            out_code[it, :] = code
            out_tpx[it, :] = tp_entry[0]
            out_tpy[it, :] = tp_entry[1]
            out_tpz[it, :] = tp_entry[2]

        total = tuple(total[c] + jnp.where(ended, path[c], 0.0)
                      for c in range(3))
        path = tuple(jnp.where(ended, 0.0, path[c]) for c in range(3))

        next_sample = jnp.where(ended, sample + stride, sample)
        regen = ended & (next_sample < limit)
        o2, d2, tm2 = cam_rays(next_sample)
        o = tuple(jnp.where(regen, o2[c], o[c]) for c in range(3))
        d = tuple(jnp.where(regen, d2[c], d[c]) for c in range(3))
        tmv = jnp.where(regen, tm2, tmv)
        tp = tuple(jnp.where(regen, 1.0, tp[c]) for c in range(3))
        bounce = jnp.where(regen, u32(0), bounce)
        alive_next = alive_next | regen
        seg = seg + regen.astype(jnp.int32)
        alive_i = alive_next.astype(jnp.int32)
        return (it + 1, o, d, tmv, tp, path, total, next_sample, bounce,
                alive_i, seg)

    # ---- init ------------------------------------------------------------
    # Under shard_map a ref read carries the operands' varying axes but the
    # arithmetic traced inside a kernel does not, so a loop carry must not
    # start as a bare ref read: the "+ 0" gives it the computed type.
    sample0 = samp_ref[...] + u32(0)
    o0, d0, tm0 = cam_rays(sample0)
    z = fi * 0.0
    alive0 = (sample0 < limit).astype(jnp.int32)
    one3 = (z + 1.0, z + 1.0, z + 1.0)
    zero3 = (z, z, z)
    if record_rows:
        # Rows past the block's own trip count stay zero (event 0 = dead).
        zi = jnp.zeros_like(alive0)

        def clear(i, c):
            out_code[i, :] = zi
            out_tpx[i, :] = z
            out_tpy[i, :] = z
            out_tpz[i, :] = z
            return c

        jax.lax.fori_loop(0, record_rows, clear, jnp.int32(0))

    def steps(carry):
        return jax.lax.fori_loop(0, ALIVE_CHECK_EVERY,
                                 lambda _, c: body(c), carry)

    def outer(_, carry):
        any_alive = jnp.sum(carry[9]) > 0
        return jax.lax.cond(any_alive, steps, lambda c: c, carry)

    carry = (jnp.int32(0), o0, d0, tm0, one3, zero3, zero3, sample0,
             sample0 * u32(0), alive0, alive0)
    carry = jax.lax.fori_loop(0, n_outer, outer, carry)
    total, seg = carry[6], carry[10]
    out_tx[...] = total[0]
    out_ty[...] = total[1]
    out_tz[...] = total[2]
    out_seg[...] = seg


# --------------------------------------------------------------------------
# JAX-side wrapper
# --------------------------------------------------------------------------


def trace_regenerative_mega(scene, cam, pixel_ids, sample_ids0, seed, *,
                            width: int, height: int, sample_stride: int,
                            sample_end, spp_cap, max_depth: int, t_min: float,
                            block: int = DEFAULT_BLOCK, interpret: bool = False,
                            record_iters: int = 0):
    """Drop-in megakernel replacement for integrator.trace_regenerative
    (same signature + return contract) for scenes where supports() holds.

    Returns (radiance V3 [B] per-lane sums, segments int32); with
    ``record_iters`` > 0 returns (radiance, segments, codes [record_iters,B]
    int32, T_prev V3 of [record_iters,B]) — the per-step residuals of the
    fused differentiable path (mega_diff.py).  ``spp_cap`` must be a static
    int: ceil(spp_cap / sample_stride) * max_depth bounds every lane's bounce
    steps, and record_iters must be at least that bound."""
    if block < 32 or block > 1024 or block & (block - 1):
        raise ValueError(f"block must be a power of two in [32, 1024]: {block}")
    n_samples = -(-int(spp_cap) // max(int(sample_stride), 1))
    if isinstance(sample_end, int):
        n_samples = min(n_samples, -(-sample_end // max(int(sample_stride), 1)))
    trip_bound = max(n_samples, 1) * max_depth
    n_outer = -(-trip_bound // ALIVE_CHECK_EVERY)
    if record_iters and record_iters < trip_bound:
        raise ValueError(f"record_iters {record_iters} < trip bound "
                         f"{trip_bound}")
    record_rows = n_outer * ALIVE_CHECK_EVERY if record_iters else 0
    B = pixel_ids.shape[0]
    limit = jnp.minimum(jnp.uint32(sample_end), jnp.uint32(spp_cap))

    rows = _pad_pow2(pack_rows(scene))
    camc = _pad_pow2(jnp.concatenate([
        cam.origin, cam.lower_left - cam.origin, cam.horizontal, cam.vertical,
        cam.u, cam.v,
        jnp.stack([cam.lens_radius, cam.time0, cam.time1 - cam.time0]),
        scene.background,
    ]).astype(jnp.float32))
    uic = jnp.stack([jnp.uint32(seed), limit, jnp.uint32(sample_stride),
                     jnp.uint32(0)]).astype(jnp.uint32)

    pad = (-B) % block
    pixel_ids = jnp.asarray(pixel_ids, jnp.uint32)
    sample_ids0 = jnp.asarray(sample_ids0, jnp.uint32)
    if pad:
        pixel_ids = jnp.pad(pixel_ids, (0, pad))
        # Padded lanes start past the sample limit -> born dead, contribute 0.
        sample_ids0 = jnp.pad(sample_ids0, (0, pad),
                              constant_values=jnp.uint32(0xFFFFFFFF))
    fi = (pixel_ids % jnp.uint32(width)).astype(jnp.float32)
    fj = (pixel_ids // jnp.uint32(width)).astype(jnp.float32)

    # Every operand enters with the union of the lane inputs' varying axes
    # (pixels vary over one mesh axis, sample ranges over another), so the
    # kernel's loop carries keep one type under shard_map(check_vma=True).
    like = fi + (sample_ids0 * 0).astype(jnp.float32)
    uic, rows, camc, pixel_ids, fi, fj, sample_ids0 = match_vma(
        like, uic, rows, camc, pixel_ids, fi, fj, sample_ids0)
    n_lanes = B + pad
    lane = lambda dt: lane_struct((n_lanes,), dt, like)  # noqa: E731
    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,))  # noqa: E731

    out_specs = [ray_spec] * 4
    out_shapes = [lane(jnp.float32)] * 3 + [lane(jnp.int32)]
    if record_rows:
        rec_spec = pl.BlockSpec((record_rows, block), lambda i: (0, i))
        out_specs.extend([rec_spec] * 4)
        out_shapes.append(
            lane_struct((record_rows, n_lanes), jnp.int32, like))
        out_shapes.extend(
            [lane_struct((record_rows, n_lanes), jnp.float32, like)] * 3)

    kern = functools.partial(
        _kernel,
        n_spheres=scene.n_spheres, n_rects=scene.n_rects,
        mat_kinds=scene.mat_kinds, tex_kinds=scene.tex_kinds,
        has_lens=cam.has_lens, has_time=cam.has_time and scene.has_motion,
        max_depth=max_depth, t_min=t_min, width=width, height=height,
        record_rows=record_rows, n_textures=scene.tex_kind.shape[0],
        n_outer=n_outer,
    )
    out = pl.pallas_call(
        kern,
        grid=(n_lanes // block,),
        in_specs=[whole(uic), whole(camc), whole(rows)] + [ray_spec] * 4,
        out_specs=out_specs,
        out_shape=out_shapes,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=block // 32,
                                           num_stages=1),
        interpret=interpret,
        name="mega_forward",
    )(uic, camc, rows, pixel_ids, fi, fj, sample_ids0)
    tx, ty, tz, seg = out[:4]

    total = V3(tx[:B], ty[:B], tz[:B])
    if record_iters:
        codes = out[4][:record_iters, :B]
        tprev = V3(out[5][:record_iters, :B], out[6][:record_iters, :B],
                   out[7][:record_iters, :B])
        return total, jnp.sum(seg[:B]), codes, tprev
    return total, jnp.sum(seg[:B])
