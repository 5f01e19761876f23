"""Independent float64 NumPy oracle renderer — the golden-image generator.

The reference ships no tests (SURVEY §4); goldens must come from a trusted
re-implementation.  This module renders the same SceneData with:
  * float64 everywhere (the reference is double-precision; the device path
    is float32),
  * the *reference's* sequential closest-hit structure: primitives are
    visited one at a time with a shrinking ``closest_so_far`` exactly like
    ``hittable_list::hit`` (hittable_list.cpp:5-19) — structurally different
    from the device path's fused argmin, so vectorization bugs don't cancel,
  * the same counter-based threefry draws as the device (ops/rng.py), so
    images agree to float32 tolerance rather than only in distribution.

Deliberately simple and slow; use small resolutions/spp in tests.
"""

from __future__ import annotations

import numpy as np

from another_raytracer.models import scene as scene_lib
from another_raytracer.ops import rng as rng_lib

# --- threefry on numpy uint32 (same constants as ops/rng.py) ---------------


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1, rounds: int = rng_lib.ROUNDS):
    """Random123-semantics threefry-2x32 (see ops/rng.py): key injection
    after each complete 4-round group, rotation schedule cycling mod 8.
    Defaults to the same round count as the device RNG."""
    with np.errstate(over="ignore"):
        k0 = np.uint32(k0) + np.zeros_like(np.asarray(x0, np.uint32))
        k1 = np.uint32(k1) + np.zeros_like(k0)
        x0 = np.asarray(x0, np.uint32).copy()
        x1 = np.asarray(x1, np.uint32).copy()
        ks2 = k0 ^ k1 ^ np.uint32(0x1BD11BDA)
        keys = (k0, k1, ks2)
        x0 = x0 + k0
        x1 = x1 + k1
        for r in range(rounds):
            x0 = x0 + x1
            x1 = _rotl(x1, rng_lib._ROTATIONS[r % 8])
            x1 = x0 ^ x1
            if (r + 1) % 4 == 0:
                inject = (r + 1) // 4
                x0 = x0 + keys[inject % 3]
                x1 = x1 + keys[(inject + 1) % 3] + np.uint32(inject)
    return x0, x1


def uniform2(seed, pixel, sample, bounce, dim):
    b0, b1 = threefry2x32(seed, (bounce << 8) | dim, pixel, sample)
    s = 2.0 ** -24
    # Match device rounding: the device value is float32((bits>>8) * 2^-24),
    # which is exact (24-bit integer scaled by a power of two).
    return (b0 >> np.uint32(8)).astype(np.float64) * s, \
           (b1 >> np.uint32(8)).astype(np.float64) * s


# --- samplers (same closed forms as ops/vecmath.py) ------------------------


def unit_vector(u1, u2):
    z = 1.0 - 2.0 * u1
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * np.pi * u2
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)


def in_unit_sphere(u1, u2, u3):
    return unit_vector(u1, u2) * np.cbrt(u3)[..., None]


def in_unit_disk(u1, u2):
    r = np.sqrt(u1)
    phi = 2.0 * np.pi * u2
    return np.stack([r * np.cos(phi), r * np.sin(phi), np.zeros_like(r)], axis=-1)


def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _unit(a):
    n = np.linalg.norm(a, axis=-1, keepdims=True)
    return a / np.where(n > 0, n, 1.0)


class Oracle:
    """f64 renderer over a SceneData (host copies of the arrays)."""

    def __init__(self, scene: scene_lib.SceneData):
        self.s = {k: np.asarray(getattr(scene, k), np.float64)
                  if np.asarray(getattr(scene, k)).dtype.kind == "f"
                  else np.asarray(getattr(scene, k))
                  for k in scene.__dataclass_fields__
                  if not isinstance(getattr(scene, k), int)}
        self.n_spheres = scene.n_spheres
        self.n_rects = scene.n_rects
        self.n_triangles = scene.n_triangles
        self.n_media = scene.n_media

    # --- textures ---------------------------------------------------------

    def texture_value(self, tid, u, v, tu, tv, p):
        s = self.s
        kind = s["tex_kind"][tid]
        out = np.empty(p.shape)
        for k in np.unique(kind):
            m = kind == k
            if k == scene_lib.TEX_SOLID:
                out[m] = s["tex_ca"][tid[m]]
            elif k == scene_lib.TEX_CHECKER:
                sines = np.prod(np.sin(10.0 * p[m]), axis=-1)
                out[m] = np.where((sines < 0)[:, None], s["tex_cb"][tid[m]], s["tex_ca"][tid[m]])
            elif k == scene_lib.TEX_NOISE:
                n = self.perlin_noise(s["tex_aux"][tid[m]], s["tex_scale"][tid[m]][:, None] * p[m])
                out[m] = 0.5 * (1.0 + n)[:, None]
            elif k == scene_lib.TEX_IMAGE:
                img = s["tex_aux"][tid[m]]
                w = s["img_w"][img]
                h = s["img_h"][img]
                cu = np.clip(tu[m], 0.0, 1.0)
                cv = 1.0 - np.clip(tv[m], 0.0, 1.0)
                i = np.minimum((cu * w).astype(np.int64), w - 1)
                j = np.minimum((cv * h).astype(np.int64), h - 1)
                out[m] = s["atlas"][s["img_off"][img] + j * w + i]
            elif k == scene_lib.TEX_BARYCENTRIC:
                out[m] = (u[m, None] * s["tex_ca"][tid[m]] + v[m, None] * s["tex_cb"][tid[m]]
                          + (1.0 - u[m] - v[m])[:, None] * s["tex_cc"][tid[m]])
        return out

    def perlin_noise(self, pid, p):
        s = self.s
        fl = np.floor(p)
        uvw = p - fl
        ijk = fl.astype(np.int64)
        sm = uvw * uvw * (3.0 - 2.0 * uvw)
        accum = np.zeros(p.shape[0])
        perm = s["per_perm"]
        ranvec = s["per_ranvec"]
        for di in range(2):
            for dj in range(2):
                for dk in range(2):
                    px = perm[pid, 0, (ijk[:, 0] + di) & 255]
                    py = perm[pid, 1, (ijk[:, 1] + dj) & 255]
                    pz = perm[pid, 2, (ijk[:, 2] + dk) & 255]
                    g = ranvec[pid, px ^ py ^ pz]
                    wv = uvw - np.array([di, dj, dk], np.float64)
                    w = ((di * sm[:, 0] + (1 - di) * (1 - sm[:, 0]))
                         * (dj * sm[:, 1] + (1 - dj) * (1 - sm[:, 1]))
                         * (dk * sm[:, 2] + (1 - dk) * (1 - sm[:, 2])))
                    accum += w * _dot(g, wv)
        return accum

    # --- closest hit, sequential like hittable_list::hit -------------------

    def closest_hit(self, o, d, time, u_media, t_min):
        """Returns dict of hit-record arrays; 'hit' False where miss."""
        B = o.shape[0]
        s = self.s
        closest = np.full(B, np.inf)
        rec = {
            "hit": np.zeros(B, bool), "p": np.zeros((B, 3)), "n": np.zeros((B, 3)),
            "front": np.zeros(B, bool), "mat": np.zeros(B, np.int64),
            "u": np.zeros(B), "v": np.zeros(B), "tu": np.zeros(B), "tv": np.zeros(B),
        }

        def to_object(xf, o, d):
            R = s["xf_rot"][xf]
            tr = s["xf_trans"][xf]
            return (o - tr) @ R, d @ R  # R^T applied via right-multiplication

        def accept(mask, t, p_obj, n_obj, xf, mat, u, v, tu, tv, is_medium=False):
            nonlocal closest
            if not mask.any():
                return
            R = s["xf_rot"][xf]
            tr = s["xf_trans"][xf]
            p_w = p_obj @ R.T + tr
            n_w = n_obj @ R.T
            m = mask
            closest = np.where(m, t, closest)
            rec["hit"] |= m
            if is_medium:
                front = np.ones(B, bool)
            else:
                front = _dot(d, n_w) < 0.0
                n_w = np.where(front[:, None], n_w, -n_w)
            for key, val in (("p", p_w), ("n", n_w)):
                rec[key][m] = val[m]
            rec["front"][m] = front[m]
            rec["mat"][m] = mat
            rec["u"][m] = u[m] if isinstance(u, np.ndarray) else u
            rec["v"][m] = v[m] if isinstance(v, np.ndarray) else v
            rec["tu"][m] = tu[m] if isinstance(tu, np.ndarray) else tu
            rec["tv"][m] = tv[m] if isinstance(tv, np.ndarray) else tv

        # spheres, one at a time with shrinking closest_so_far
        for i in range(self.n_spheres):
            xf = s["sph_xf"][i]
            ob, db = to_object(xf, o, d)
            frac = (time - s["sph_t0"][i]) / (s["sph_t1"][i] - s["sph_t0"][i])
            center = s["sph_c0"][i] + frac[:, None] * (s["sph_c1"][i] - s["sph_c0"][i])
            r = s["sph_r"][i]
            oc = ob - center
            a = _dot(db, db)
            hb = _dot(oc, db)
            c = _dot(oc, oc) - r * r
            disc = hb * hb - a * c
            with np.errstate(invalid="ignore"):
                sq = np.sqrt(np.maximum(disc, 0.0))
                r1 = (-hb - sq) / a
                r2 = (-hb + sq) / a
            root = np.where((r1 > t_min) & (r1 < closest), r1, r2)
            ok = (disc > 0) & (root > t_min) & (root < closest)
            p_obj = ob + root[:, None] * db
            n_obj = (p_obj - center) / r
            theta = np.arccos(np.clip(-n_obj[:, 1], -1, 1))
            phi = np.arctan2(-n_obj[:, 2], n_obj[:, 0]) + np.pi
            u = phi / (2 * np.pi) * s["sph_has_uv"][i]
            v = theta / np.pi * s["sph_has_uv"][i]
            accept(ok, root, p_obj, n_obj, xf, s["sph_mat"][i], u, v, u, v)

        for i in range(self.n_rects):
            xf = s["rect_xf"][i]
            ob, db = to_object(xf, o, d)
            ax = s["rect_axis"][i]
            au, av = [x for x in (0, 1, 2) if x != ax]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (s["rect_k"][i] - ob[:, ax]) / db[:, ax]
            pu = ob[:, au] + t * db[:, au]
            pv = ob[:, av] + t * db[:, av]
            lo = s["rect_lo"][i]
            hi = s["rect_hi"][i]
            ok = (np.isfinite(t) & (t > t_min) & (t < closest)
                  & (pu >= lo[0]) & (pu <= hi[0]) & (pv >= lo[1]) & (pv <= hi[1]))
            n_obj = np.zeros((o.shape[0], 3))
            n_obj[:, ax] = 1.0
            u = (pu - lo[0]) / (hi[0] - lo[0])
            v = (pv - lo[1]) / (hi[1] - lo[1])
            p_obj = ob + t[:, None] * db
            accept(ok, t, p_obj, n_obj, xf, s["rect_mat"][i], u, v, u, v)

        for i in range(self.n_triangles):
            xf = s["tri_xf"][i]
            ob, db = to_object(xf, o, d)
            v0, v1, v2 = s["tri_v0"][i], s["tri_v1"][i], s["tri_v2"][i]
            n = np.cross(v1 - v0, v2 - v0)
            nd = _dot(n, db)
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (np.dot(n, v0) - _dot(n, ob)) / nd
            p = ob + t[:, None] * db
            w0 = _dot(n, np.cross(v1 - v0, p - v0))
            w1 = _dot(n, np.cross(v2 - v1, p - v1))
            w2 = _dot(n, np.cross(v0 - v2, p - v2))
            ok = (np.isfinite(t) & (t > t_min) & (t < closest)
                  & (w0 >= 0) & (w1 >= 0) & (w2 >= 0))
            n2 = np.dot(n, n)
            u = w1 / n2
            v = w2 / n2
            w = 1.0 - u - v
            uvs = (u[:, None] * s["tri_uv0"][i] + v[:, None] * s["tri_uv1"][i]
                   + w[:, None] * s["tri_uv2"][i])
            # Oracle normalizes the triangle normal (documented divergence
            # from triangle.h:79 which stores the raw cross product).
            # Degenerate (zero-area) triangles never pass `ok`, so the guard
            # only silences the warning, not a behavior change.
            n_len = np.linalg.norm(n)
            nb = np.broadcast_to(n / (n_len if n_len > 0.0 else 1.0), p.shape)
            accept(ok, t, p, nb, xf, s["tri_mat"][i], u, v, uvs[:, 0], uvs[:, 1])

        for i in range(self.n_media):
            xf = s["med_xf"][i]
            ob, db = to_object(xf, o, d)
            if s["med_kind"][i] == scene_lib.MED_SPHERE:
                center, r = s["med_a"][i], s["med_b"][i][0]
                oc = ob - center
                a = _dot(db, db)
                hb = _dot(oc, db)
                c = _dot(oc, oc) - r * r
                disc = hb * hb - a * c
                sq = np.sqrt(np.maximum(disc, 0.0))
                t1 = (-hb - sq) / a
                t2 = (-hb + sq) / a
                bok = disc > 0
            else:
                with np.errstate(divide="ignore", invalid="ignore"):
                    tA = (s["med_a"][i] - ob) / db
                    tB = (s["med_b"][i] - ob) / db
                t1 = np.max(np.minimum(tA, tB), axis=-1)
                t2 = np.min(np.maximum(tA, tB), axis=-1)
                bok = t1 < t2
            bok &= t2 > t1 + 1e-4
            r1 = np.maximum(t1, t_min)
            r2 = np.minimum(t2, closest)
            bok &= r1 < r2
            r1 = np.maximum(r1, 0.0)
            ray_len = np.linalg.norm(d, axis=-1)
            dist = (r2 - r1) * ray_len
            with np.errstate(divide="ignore"):
                hd = s["med_neg_inv_density"][i] * np.log(u_media[:, i])
            ok = bok & (hd <= dist)
            t = r1 + hd / ray_len
            p_obj = ob + t[:, None] * db
            n_obj = np.broadcast_to(np.array([1.0, 0, 0]), p_obj.shape)
            z = np.zeros(o.shape[0])
            accept(ok, t, p_obj, n_obj, xf, s["med_mat"][i], z, z, z, z, is_medium=True)

        rec["t"] = closest
        return rec

    # --- integrator --------------------------------------------------------

    def trace(self, o, d, time, pixel, sample, seed, max_depth, t_min):
        s = self.s
        B = o.shape[0]
        throughput = np.ones((B, 3))
        radiance = np.zeros((B, 3))
        alive = np.ones(B, bool)
        for bounce in range(max_depth):
            if not alive.any():
                break
            u_media = np.stack(
                [uniform2(seed, pixel, sample, bounce, rng_lib.DIM_MEDIUM + 2 * m)[0]
                 for m in range(self.n_media)], axis=-1
            ) if self.n_media else np.zeros((B, 0))
            rec = self.closest_hit(o, d, time, u_media, t_min)
            miss = alive & ~rec["hit"]
            radiance[miss] += throughput[miss] * s["background"]
            live = alive & rec["hit"]

            mat = rec["mat"]
            kind = s["mat_kind"][mat]
            tex = s["mat_tex"][mat]
            alb = self.texture_value(tex, rec["u"], rec["v"], rec["tu"], rec["tv"], rec["p"])

            is_light = kind == scene_lib.MAT_DIFFUSE_LIGHT
            lm = live & is_light
            radiance[lm] += throughput[lm] * alb[lm]

            u1, u2 = uniform2(seed, pixel, sample, bounce, rng_lib.DIM_SCATTER_A)
            u3, u4 = uniform2(seed, pixel, sample, bounce, rng_lib.DIM_SCATTER_B)
            runit = unit_vector(u1, u2)
            rsph = runit * np.cbrt(u3)[:, None]
            n = rec["n"]
            ud = _unit(d)

            newd = n + runit
            nz = np.all(np.abs(newd) < 1e-8, axis=-1)
            newd[nz] = n[nz]
            ok = live & ~is_light
            atten = alb.copy()

            m_metal = kind == scene_lib.MAT_METAL
            refl = ud - 2 * _dot(ud, n)[:, None] * n
            mdir = refl + s["mat_fuzz"][mat][:, None] * rsph
            newd = np.where(m_metal[:, None], mdir, newd)
            ok &= ~(m_metal & (_dot(mdir, n) <= 0))

            m_die = kind == scene_lib.MAT_DIELECTRIC
            ir = s["mat_ir"][mat]
            ratio = np.where(rec["front"], 1.0 / ir, ir)
            cos_t = np.minimum(_dot(-ud, n), 1.0)
            sin_t = np.sqrt(np.maximum(0.0, 1.0 - cos_t ** 2))
            cannot = ratio * sin_t > 1.0
            r0 = ((1 - ratio) / (1 + ratio)) ** 2
            refl_p = r0 + (1 - r0) * (1 - cos_t) ** 5
            perp = ratio[:, None] * (ud + cos_t[:, None] * n)
            par = -np.sqrt(np.abs(1.0 - _dot(perp, perp)))[:, None] * n
            refr = perp + par
            ddir = np.where((cannot | (refl_p > u4))[:, None], refl, refr)
            newd = np.where(m_die[:, None], ddir, newd)
            atten = np.where(m_die[:, None], 1.0, atten)

            m_iso = kind == scene_lib.MAT_ISOTROPIC
            newd = np.where(m_iso[:, None], rsph, newd)

            alive = ok
            throughput = np.where(alive[:, None], throughput * atten, throughput)
            o = np.where(alive[:, None], rec["p"], o)
            d = np.where(alive[:, None], newd, d)
        return radiance

    def render(self, cam_params, width, height, spp, max_depth, seed, t_min=1e-3):
        """cam_params: dict from make_camera inputs (f64 camera built here).

        Returns radiance sums [H*W, 3] (un-averaged, like render_radiance).
        """
        import math
        lookfrom = np.asarray(cam_params["lookfrom"], np.float64)
        lookat = np.asarray(cam_params["lookat"], np.float64)
        vup = np.asarray(cam_params.get("vup", (0, 1, 0)), np.float64)
        vfov = cam_params.get("vfov", 40.0)
        aspect = cam_params.get("aspect_ratio", width / height)
        aperture = cam_params.get("aperture", 0.0)
        focus = cam_params.get("focus_dist", 10.0)
        time0 = cam_params.get("time0", 0.0)
        time1 = cam_params.get("time1", 0.0)

        h = math.tan(math.radians(vfov) / 2)
        vh = 2.0 * h
        vw = aspect * vh
        w = _unit(lookfrom - lookat)
        u = _unit(np.cross(vup, w))
        v = np.cross(w, u)
        horizontal = focus * vw * u
        vertical = focus * vh * v
        lower_left = lookfrom - horizontal / 2 - vertical / 2 - focus * w
        lens_radius = aperture / 2

        npix = width * height
        pixel = np.arange(npix, dtype=np.uint32)
        acc = np.zeros((npix, 3))
        for sidx in range(spp):
            sample = np.full(npix, sidx, np.uint32)
            ju, jv = uniform2(seed, pixel, sample, rng_lib.CAMERA_BOUNCE, rng_lib.DIM_PIXEL_JITTER)
            lu, lv = uniform2(seed, pixel, sample, rng_lib.CAMERA_BOUNCE, rng_lib.DIM_LENS)
            tu, _ = uniform2(seed, pixel, sample, rng_lib.CAMERA_BOUNCE, rng_lib.DIM_TIME)
            i = (pixel % width).astype(np.float64)
            j = (pixel // width).astype(np.float64)
            sgrid = (i + ju) / (width - 1)
            tgrid = (height - 1 - j + jv) / (height - 1)
            rd = lens_radius * in_unit_disk(lu, lv)
            offset = rd[:, 0:1] * u + rd[:, 1:2] * v
            o = lookfrom + offset
            dvec = lower_left + sgrid[:, None] * horizontal + tgrid[:, None] * vertical - lookfrom - offset
            time = time0 + tu * (time1 - time0)
            acc += self.trace(o, dvec, time, pixel, sample, seed, max_depth, t_min)
        return acc
