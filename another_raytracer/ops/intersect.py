"""Vectorized closest-hit over the flat SoA scene (column layout).

The reference's hot path is virtual dispatch through ``hittable::hit``
recursion (hittable_list.cpp:5-19 + bvh.cpp:44-52).  Data-parallel design:
every primitive kind is intersected for a whole ray batch at once as fused
broadcast arithmetic ([B, N] lanes feeding a min-reduction), chunked over
primitives with static slices so XLA sees fixed shapes.  The winner
(t, kind, index) per ray is found first with cheap arithmetic only; the full
hit record (point, normal, UV, material) is then *recomputed only for the
winning primitive* per ray — a [B]-sized gather instead of a [B, N] payload.
The recompute is differentiable (the winner choice is a detached discrete
decision), so gradients flow to geometry parameters through the hit point.

All per-ray state is column-SoA (``ops.vec3.V3`` — three [B] arrays), so
every component is a contiguous [B] vector.

Instancing: primitives carry a transform id; rays are moved into object
space with the gathered inverse transform — the vectorized form of
``rotate_y::hit``/``translate::hit`` (reference: src/engine/hittable.cpp).

Behavioral contracts preserved (with reference locations):
  * sphere: half-b quadratic, nearest root in (t_min, t_max) (sphere.h:39-65),
    UV from the object-space outward normal (sphere.h:24-37);
  * moving sphere: center lerped by ray time (moving_sphere.h:29-31), UV left
    at 0 — the reference never fills it (moving_sphere.h:33-58);
  * rect: plane solve + inclusive 2D bound check (aarect.cpp);
  * triangle: scratchapixel geometric test with area-ratio barycentrics
    (triangle.h:22-87).  DIVERGENCE: the reference leaves the triangle normal
    unnormalized in hit_record (the raw cross product), which skews its
    lambertian lobes by triangle area; we normalize (PARITY.md #3);
  * constant medium: boundary entry/exit interval then exponential free-flight
    sampling (constant_medium.h:42-80), with the analytic two-root interval
    replacing the double hittable::hit probe.

All guarded divisions/sqrts use where-style masking so discarded lanes can
never NaN-poison reverse-mode cotangents (0 * inf = NaN).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from another_raytracer.models import scene as scene_lib
from another_raytracer.ops import vec3
from another_raytracer.ops.gather import Lookup
from another_raytracer.ops.vec3 import V3

BIG = jnp.float32(3e37)  # effectively +infinity for t comparisons
MEDIUM_REHIT_EPS = 1e-4  # reference: constant_medium.h:47 second-probe offset

# Primitive chunk size for the scan over large primitive arrays.
PRIM_CHUNK = 512


class HitRecord(NamedTuple):
    t: jnp.ndarray  # [B]
    p: V3  # world-space hit point
    normal: V3  # unit, faced toward the incoming ray
    front_face: jnp.ndarray  # [B] bool
    mat: jnp.ndarray  # [B] int32 material id
    u: jnp.ndarray  # [B] raw surface parameter (barycentric u for triangles)
    v: jnp.ndarray  # [B]
    tu: jnp.ndarray  # [B] texture coordinate (blended texcoord for triangles)
    tv: jnp.ndarray  # [B]


def _col3(arr2d, idx=None):
    """[N,3] table -> V3 of [N] columns (or gathered [B] columns by idx)."""
    if idx is None:
        return V3(arr2d[:, 0], arr2d[:, 1], arr2d[:, 2])
    return V3(arr2d[:, 0][idx], arr2d[:, 1][idx], arr2d[:, 2][idx])


def _rows(rot):
    """[N,3,3] rotations -> 3 V3 rows of [N] components (world-from-object)."""
    return (
        V3(rot[:, 0, 0], rot[:, 0, 1], rot[:, 0, 2]),
        V3(rot[:, 1, 0], rot[:, 1, 1], rot[:, 1, 2]),
        V3(rot[:, 2, 0], rot[:, 2, 1], rot[:, 2, 2]),
    )


def _cols(rot):
    """[N,3,3] rotations -> rows of R^T (object-from-world)."""
    return (
        V3(rot[:, 0, 0], rot[:, 1, 0], rot[:, 2, 0]),
        V3(rot[:, 0, 1], rot[:, 1, 1], rot[:, 2, 1]),
        V3(rot[:, 0, 2], rot[:, 1, 2], rot[:, 2, 2]),
    )


def _identity_xf(scene: scene_lib.SceneData) -> bool:
    """Static check: scene has only the identity transform."""
    return scene.xf_rot.shape[0] == 1


def _bcast(v: V3) -> V3:
    """[B] components -> [B,1] for broadcasting against [N] primitives."""
    return V3(v.x[:, None], v.y[:, None], v.z[:, None])


def _ray_to_object_bn(scene, xf_ids, o: V3, d: V3):
    """World rays [B] against primitives' transforms [N] -> object rays with
    [B, N] components: o' = R^T (o - tr), d' = R^T d."""
    rot = scene.xf_rot[xf_ids]
    tr = _col3(scene.xf_trans, xf_ids)
    rt = _cols(rot)  # rows of R^T, [N] components
    oc = V3(o.x[:, None] - tr.x[None, :], o.y[:, None] - tr.y[None, :], o.z[:, None] - tr.z[None, :])
    rtx, rty, rtz = (V3(r.x[None, :], r.y[None, :], r.z[None, :]) for r in rt)
    o_b = V3(vec3.dot(rtx, oc), vec3.dot(rty, oc), vec3.dot(rtz, oc))
    db = _bcast(d)
    d_b = V3(vec3.dot(rtx, db), vec3.dot(rty, db), vec3.dot(rtz, db))
    return o_b, d_b


def _ray_to_object_gathered(scene, xf_ids, o: V3, d: V3):
    """Per-ray gathered transforms ([B]): returns (o_obj, d_obj, rows of R)
    where rows are for object->world (normal/point transforms).  All twelve
    transform scalars come through one one-hot matmul (ops/gather.py)."""
    r = scene.xf_rot
    look = Lookup(xf_ids, r.shape[0])
    (r00, r01, r02, r10, r11, r12, r20, r21, r22, tx, ty, tz) = look(
        r[:, 0, 0], r[:, 0, 1], r[:, 0, 2],
        r[:, 1, 0], r[:, 1, 1], r[:, 1, 2],
        r[:, 2, 0], r[:, 2, 1], r[:, 2, 2],
        scene.xf_trans[:, 0], scene.xf_trans[:, 1], scene.xf_trans[:, 2],
    )
    rows = (V3(r00, r01, r02), V3(r10, r11, r12), V3(r20, r21, r22))
    cols = (V3(r00, r10, r20), V3(r01, r11, r21), V3(r02, r12, r22))
    tr = V3(tx, ty, tz)
    oc = o - tr
    o_b = V3(vec3.dot(cols[0], oc), vec3.dot(cols[1], oc), vec3.dot(cols[2], oc))
    d_b = V3(vec3.dot(cols[0], d), vec3.dot(cols[1], d), vec3.dot(cols[2], d))
    return o_b, d_b, rows, tr


# --------------------------------------------------------------------------
# Per-kind t computation.  Each returns (t [B, N], valid [B, N]).
# --------------------------------------------------------------------------


def _sphere_t(scene, sl, o: V3, d: V3, time, t_min, t_max):
    """Quadratic sphere test against time-lerped centers (sphere.h:39-65,
    moving_sphere.h:29-58)."""
    c0 = _col3(scene.sph_c0[sl])
    c1 = _col3(scene.sph_c1[sl])
    t0 = scene.sph_t0[sl]
    t1 = scene.sph_t1[sl]
    r = scene.sph_r[sl]
    if not _identity_xf(scene):
        o_b, d_b = _ray_to_object_bn(scene, scene.sph_xf[sl], o, d)
    else:
        o_b, d_b = _bcast(o), _bcast(d)

    # center(time): static spheres have c1 == c0 so the lerp is inert.
    frac = (time[:, None] - t0[None, :]) / (t1 - t0)[None, :]
    cdel = c1 - c0
    center = V3(
        c0.x[None, :] + frac * cdel.x[None, :],
        c0.y[None, :] + frac * cdel.y[None, :],
        c0.z[None, :] + frac * cdel.z[None, :],
    )
    oc = o_b - center
    a = vec3.length_squared(d_b)
    half_b = vec3.dot(oc, d_b)
    c = vec3.length_squared(oc) - (r * r)[None, :]
    disc = half_b * half_b - a * c
    hit_disc = disc > 0.0
    # where-guard before sqrt: lanes with disc <= 0 are discarded by `valid`,
    # but sqrt'(0) = inf would still NaN-poison reverse-mode cotangents.
    sqrtd = jnp.sqrt(jnp.where(hit_disc, disc, 1.0))
    root1 = (-half_b - sqrtd) / a
    root2 = (-half_b + sqrtd) / a
    r1_ok = (root1 > t_min) & (root1 < t_max)
    root = jnp.where(r1_ok, root1, root2)
    valid = hit_disc & (root > t_min) & (root < t_max)
    return root, valid


def _axis_component(v: V3, axis):
    """Select per-primitive axis component: axis [N] in {0,1,2}; v has [B,N]
    or [N] components.  Uses two selects (cheaper than a one-hot dot)."""
    return jnp.where(axis == 0, v.x, jnp.where(axis == 1, v.y, v.z))


def _rect_t(scene, sl, o: V3, d: V3, t_min, t_max):
    """Axis-rect plane solve + inclusive bound check (aarect.cpp)."""
    axis = scene.rect_axis[sl]  # [N]
    k = scene.rect_k[sl]
    lo = scene.rect_lo[sl]  # [N,2]
    hi = scene.rect_hi[sl]
    if not _identity_xf(scene):
        o_b, d_b = _ray_to_object_bn(scene, scene.rect_xf[sl], o, d)
    else:
        o_b, d_b = _bcast(o), _bcast(d)

    ax = axis[None, :]
    o_ax = _axis_component(o_b, ax)
    d_ax = _axis_component(d_b, ax)
    parallel = d_ax == 0.0
    t = jnp.where(parallel, BIG, (k[None, :] - o_ax) / jnp.where(parallel, 1.0, d_ax))

    # free axes in ascending order: axis 0 -> (1,2), 1 -> (0,2), 2 -> (0,1)
    au = jnp.where(ax == 0, 1, 0)
    av = jnp.where(ax == 2, 1, 2)
    pu = _axis_component(o_b, au) + t * _axis_component(d_b, au)
    pv = _axis_component(o_b, av) + t * _axis_component(d_b, av)

    inside = (pu >= lo[None, :, 0]) & (pu <= hi[None, :, 0]) & \
             (pv >= lo[None, :, 1]) & (pv <= hi[None, :, 1])
    valid = inside & (t > t_min) & (t < t_max) & ~parallel
    return t, valid


def _triangle_t(scene, sl, o: V3, d: V3, t_min, t_max):
    """Scratchapixel-style plane + edge half-plane test (triangle.h:22-87).
    Returns t only; barycentrics are recomputed for the winner."""
    v0 = _col3(scene.tri_v0[sl])
    v1 = _col3(scene.tri_v1[sl])
    v2 = _col3(scene.tri_v2[sl])
    if not _identity_xf(scene):
        o_b, d_b = _ray_to_object_bn(scene, scene.tri_xf[sl], o, d)
    else:
        o_b, d_b = _bcast(o), _bcast(d)

    n = vec3.cross(v1 - v0, v2 - v0)  # [N] components
    n_row = V3(n.x[None, :], n.y[None, :], n.z[None, :])
    ndotd = vec3.dot(n_row, d_b)
    ndoto = vec3.dot(n_row, o_b)
    parallel = ndotd == 0.0
    t = jnp.where(
        parallel, BIG,
        (vec3.dot(n, v0)[None, :] - ndoto) / jnp.where(parallel, 1.0, ndotd),
    )

    p = o_b + d_b * t
    row = lambda v: V3(v.x[None, :], v.y[None, :], v.z[None, :])  # noqa: E731
    e0 = row(v1 - v0)
    e1 = row(v2 - v1)
    e2 = row(v0 - v2)
    w0 = vec3.dot(n_row, vec3.cross(e0, p - row(v0)))
    w1 = vec3.dot(n_row, vec3.cross(e1, p - row(v1)))
    w2 = vec3.dot(n_row, vec3.cross(e2, p - row(v2)))

    valid = (
        (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
        & (t > t_min) & (t < t_max) & ~parallel
    )
    return t, valid


def _medium_interval(scene, o: V3, d: V3):
    """Boundary entry/exit interval (t1, t2, boundary_hit) for all media,
    components [B, Nm].  Analytic equivalent of the reference's two
    hittable::hit probes (constant_medium.h:42-47)."""
    kind = scene.med_kind  # [Nm]
    a3 = _col3(scene.med_a)
    b3 = _col3(scene.med_b)
    if not _identity_xf(scene):
        o_b, d_b = _ray_to_object_bn(scene, scene.med_xf, o, d)
    else:
        o_b, d_b = _bcast(o), _bcast(d)

    # Sphere boundary: both quadratic roots.
    oc = V3(o_b.x - a3.x[None, :], o_b.y - a3.y[None, :], o_b.z - a3.z[None, :])
    qa = vec3.length_squared(d_b)
    half_b = vec3.dot(oc, d_b)
    qc = vec3.length_squared(oc) - (b3.x * b3.x)[None, :]
    disc = half_b * half_b - qa * qc
    s_ok = disc > 0.0
    sq = jnp.sqrt(jnp.where(s_ok, disc, 1.0))  # grad-safe
    s_t1 = (-half_b - sq) / qa
    s_t2 = (-half_b + sq) / qa

    # Box boundary: slab interval.  Signed-epsilon divide guard keeps lanes
    # and reverse-mode cotangents finite for axis-parallel rays.
    def slab(dc, oc_, lo, hi):
        d_safe = jnp.where(jnp.abs(dc) < 1e-20, jnp.where(dc < 0, -1e-20, 1e-20), dc)
        inv = 1.0 / d_safe
        tA = (lo[None, :] - oc_) * inv
        tB = (hi[None, :] - oc_) * inv
        return jnp.minimum(tA, tB), jnp.maximum(tA, tB)

    nx, xx = slab(d_b.x, o_b.x, a3.x, b3.x)
    ny, xy = slab(d_b.y, o_b.y, a3.y, b3.y)
    nz, xz = slab(d_b.z, o_b.z, a3.z, b3.z)
    b_t1 = jnp.maximum(jnp.maximum(nx, ny), nz)
    b_t2 = jnp.minimum(jnp.minimum(xx, xy), xz)
    b_ok = b_t1 < b_t2

    is_sphere = (kind == scene_lib.MED_SPHERE)[None, :]
    t1 = jnp.where(is_sphere, s_t1, b_t1)
    t2 = jnp.where(is_sphere, s_t2, b_t2)
    ok = jnp.where(is_sphere, s_ok, b_ok)
    # The reference's second probe starts at t1 + 1e-4; a thinner slab than
    # that would fail its second hit.
    ok = ok & (t2 > t1 + MEDIUM_REHIT_EPS)
    return t1, t2, ok


def _medium_t(scene, o: V3, d: V3, u_media, t_min, t_max):
    """Exponential free-flight sample inside boundary (constant_medium.h:49-80).
    u_media: [B, Nm] uniforms."""
    t1, t2, ok = _medium_interval(scene, o, d)
    r1 = jnp.maximum(t1, t_min)
    r2 = jnp.minimum(t2, t_max)
    ok = ok & (r1 < r2)
    r1 = jnp.maximum(r1, 0.0)
    ray_len = vec3.length(d)[:, None]
    dist_inside = (r2 - r1) * ray_len
    # log(0) = -inf -> hit_dist = +inf -> rejected, matching the reference
    # when random_double() returns 0.
    hit_dist = scene.med_neg_inv_density[None, :] * jnp.log(u_media)
    ok = ok & (hit_dist <= dist_inside)
    t = r1 + hit_dist / ray_len
    return t, ok


# --------------------------------------------------------------------------
# Closest hit
# --------------------------------------------------------------------------


def _fold_kind(best, t, valid, kind, base_idx):
    """Merge a [B, N] candidate set into the running (t, kind, idx) best."""
    bt, bk, bi = best
    t = jnp.where(valid, t, BIG)
    i = jnp.argmin(t, axis=-1)
    tm = jnp.min(t, axis=-1)
    better = tm < bt
    return (
        jnp.where(better, tm, bt),
        jnp.where(better, kind, bk),
        jnp.where(better, i.astype(jnp.int32) + base_idx, bi),
    )


def _scan_kind(best, n_total, chunk_fn, kind):
    """Fold a whole primitive kind, chunked when large (static slices)."""
    for start in range(0, n_total, PRIM_CHUNK):
        sl = slice(start, min(start + PRIM_CHUNK, n_total))
        t, valid = chunk_fn(sl)
        best = _fold_kind(best, t, valid, kind, jnp.int32(start))
    return best


def _fold_bvh(scene, best, nodes, rows, o, d, time, t_min, prim):
    """Fold one packed BVH's winner into the running best.  The traversal
    returns rows' slot-9 codes (id*4 + kind) for improved lanes and copies
    the init value through otherwise, so the decode is gated on improved."""
    from another_raytracer.ops import bvh as bvh_ops

    bt, bk, bi = best
    t, code, improved = bvh_ops.traverse_packed(
        nodes, rows, o, d, time, t_min, bt, bi,
        leaf_size=scene.bvh_leaf_size, prim=prim,
    )
    kind = jnp.where(improved, jax.lax.rem(code, 4), bk)
    idx = jnp.where(improved, jax.lax.div(code, 4), bi)
    return (t, kind, idx)


def closest_hit(scene, o: V3, d: V3, time, u_media, t_min):
    """Closest intersection over all primitive kinds.

    Returns (t [B], kind [B] int32 with -1 = miss, idx [B] within-kind).

    Kinds flagged ``*_in_bvh`` on the scene resolve through BVH traversal
    (the reference BVHs its random-scene spheres and final-scene ground
    boxes too, scene_manager.cpp:61,176,231); the rest go through the
    chunked [B, N] sweeps.  BVH folds run first so their winner t tightens
    the sweeps' t_max.
    """
    # Derive the init from the rays so it carries their varying-axes type:
    # fresh jnp.full constants are replicated under shard_map(check_vma=True).
    z = o.x * 0.0
    best = (
        z + BIG,
        z.astype(jnp.int32) - 1,
        z.astype(jnp.int32),
    )
    if scene.n_bvh_nodes:  # planar tree: triangles and/or transformed-rect quads
        best = _fold_bvh(scene, best, scene.bvh_packed_nodes,
                         scene.bvh_packed_tris, o, d, time, t_min, "planar")
    if scene.n_rect_bvh_nodes:  # native axis-rect tree (identity transforms)
        best = _fold_bvh(scene, best, scene.rect_bvh_nodes,
                         scene.rect_bvh_rows, o, d, time, t_min, "rect")
    if scene.n_sph_bvh_nodes:
        best = _fold_bvh(scene, best, scene.sph_bvh_nodes,
                         scene.sph_bvh_rows, o, d, time, t_min, "sphere")
    if scene.n_spheres and not scene.sph_in_bvh:
        best = _scan_kind(
            best, scene.n_spheres,
            lambda sl: _sphere_t(scene, sl, o, d, time, t_min, best[0][:, None]),
            scene_lib.PRIM_SPHERE,
        )
    if scene.n_rects and not scene.rect_in_bvh:
        best = _scan_kind(
            best, scene.n_rects,
            lambda sl: _rect_t(scene, sl, o, d, t_min, best[0][:, None]),
            scene_lib.PRIM_RECT,
        )
    if scene.n_triangles and not scene.tri_in_bvh:
        best = _scan_kind(
            best, scene.n_triangles,
            lambda sl: _triangle_t(scene, sl, o, d, t_min, best[0][:, None]),
            scene_lib.PRIM_TRIANGLE,
        )
    if scene.n_media:
        t, valid = _medium_t(scene, o, d, u_media, t_min, best[0][:, None])
        best = _fold_kind(best, t, valid, scene_lib.PRIM_MEDIUM, jnp.int32(0))
    return best


# --------------------------------------------------------------------------
# Winner hit-record reconstruction (all [B]-sized, differentiable)
# --------------------------------------------------------------------------


def _sphere_record(scene, o, d, time, t, idx):
    ii = jnp.clip(idx, 0, scene.n_spheres - 1)
    if scene.n_spheres > 512:  # gather.MAX_ONEHOT_K: one row gather
        fdt = scene.sph_r.dtype
        packed = jnp.concatenate(
            [scene.sph_c0, scene.sph_c1, scene.sph_t0[:, None],
             scene.sph_t1[:, None], scene.sph_r[:, None],
             scene.sph_has_uv[:, None], scene.sph_mat.astype(fdt)[:, None],
             scene.sph_xf.astype(fdt)[:, None]], axis=1)  # [N, 12]
        cols = _unpack_rows(packed[ii])
        c0 = V3(cols[0], cols[1], cols[2])
        c1 = V3(cols[3], cols[4], cols[5])
        t0, t1, r, has_uv = cols[6:10]
        mat_packed = cols[10].astype(jnp.int32)
        xf = cols[11].astype(jnp.int32)
    else:
        look = Lookup(ii, scene.n_spheres)
        (c0x, c0y, c0z, c1x, c1y, c1z, t0, t1, r, has_uv, xf) = look(
            scene.sph_c0[:, 0], scene.sph_c0[:, 1], scene.sph_c0[:, 2],
            scene.sph_c1[:, 0], scene.sph_c1[:, 1], scene.sph_c1[:, 2],
            scene.sph_t0, scene.sph_t1, scene.sph_r, scene.sph_has_uv,
            scene.sph_xf,
        )
        c0 = V3(c0x, c0y, c0z)
        c1 = V3(c1x, c1y, c1z)
        mat_packed = None
    o_b, d_b, rows, _ = _ray_to_object_gathered(scene, xf, o, d)
    frac = (time - t0) / (t1 - t0)
    center = c0 + (c1 - c0) * frac
    # Differentiable t recompute: the winner index (and which quadratic root
    # it was) is a detached discrete decision; the root value itself is a
    # smooth function of sphere parameters, so gradients w.r.t. centers and
    # radii flow through the hit point.
    oc = o_b - center
    a = vec3.length_squared(d_b)
    half_b = vec3.dot(oc, d_b)
    c = vec3.length_squared(oc) - r * r
    disc = half_b * half_b - a * c
    sq = jnp.sqrt(jnp.where(disc > 0, disc, 1.0))
    root1 = (-half_b - sq) / a
    root2 = (-half_b + sq) / a
    pick1 = jnp.abs(root1 - t) <= jnp.abs(root2 - t)
    t = jnp.where(disc > 0, jnp.where(pick1, root1, root2), t)
    p_obj = o_b + d_b * t
    # Outward normal in object space; /r handles sign for negative radii.
    n_obj = (p_obj - center) * (1.0 / r)
    # Spherical UV from the object-space outward normal (sphere.h:24-37).
    # stop_gradient: arccos/arctan2 have infinite pole derivatives and even a
    # zero cotangent times inf is NaN; sphere UVs only feed nearest-texel
    # lookups (not coordinate-differentiable anyway).
    n_uv = jax.lax.stop_gradient(n_obj)
    theta = jnp.arccos(jnp.clip(-n_uv.y, -1.0, 1.0))
    phi = jnp.arctan2(-n_uv.z, n_uv.x) + jnp.pi
    u = (phi / (2.0 * jnp.pi)) * has_uv
    v = (theta / jnp.pi) * has_uv
    n_world = vec3.rotate(rows, n_obj)
    p_world = o + d * t
    mat = mat_packed if mat_packed is not None else look(scene.sph_mat)[0]
    return t, p_world, n_world, mat, u, v, u, v


def _rect_record(scene, o, d, t, idx):
    ii = jnp.clip(idx, 0, scene.n_rects - 1)
    if scene.n_rects > 512:  # gather.MAX_ONEHOT_K
        # One [N,8] row gather instead of 8 column gathers — the final
        # scene has 2,401 rects, well past the one-hot matmul's range.  int
        # columns are exact in f32 (< 2^24); the concatenate is
        # loop-invariant so XLA hoists it.
        fdt = scene.rect_k.dtype
        packed = jnp.concatenate(
            [scene.rect_axis.astype(fdt)[:, None], scene.rect_k[:, None],
             scene.rect_lo, scene.rect_hi,
             scene.rect_mat.astype(fdt)[:, None],
             scene.rect_xf.astype(fdt)[:, None]], axis=1)  # [N, 8]
        cols = _unpack_rows(packed[ii])
        axis = cols[0].astype(jnp.int32)
        k, lo0, lo1, hi0, hi1 = cols[1:6]
        mat = cols[6].astype(jnp.int32)
        xf = cols[7].astype(jnp.int32)
    else:
        look = Lookup(ii, scene.n_rects)
        (axis, k, lo0, lo1, hi0, hi1, mat, xf) = look(
            scene.rect_axis, scene.rect_k,
            scene.rect_lo[:, 0], scene.rect_lo[:, 1],
            scene.rect_hi[:, 0], scene.rect_hi[:, 1],
            scene.rect_mat, scene.rect_xf,
        )
    o_b, d_b, rows, _ = _ray_to_object_gathered(scene, xf, o, d)
    # Differentiable t recompute from the plane equation.
    o_ax = _axis_component(o_b, axis)
    d_ax = _axis_component(d_b, axis)
    ok = d_ax != 0.0
    t = jnp.where(ok, (k - o_ax) / jnp.where(ok, d_ax, 1.0), t)
    p_obj = o_b + d_b * t
    au = jnp.where(axis == 0, 1, 0)
    av = jnp.where(axis == 2, 1, 2)
    pu = _axis_component(p_obj, au)
    pv = _axis_component(p_obj, av)
    u = (pu - lo0) / (hi0 - lo0)
    v = (pv - lo1) / (hi1 - lo1)
    one = jnp.ones_like(t)
    zero = jnp.zeros_like(t)
    n_obj = V3(
        jnp.where(axis == 0, one, zero),
        jnp.where(axis == 1, one, zero),
        jnp.where(axis == 2, one, zero),
    )
    n_world = vec3.rotate(rows, n_obj)
    p_world = o + d * t
    return t, p_world, n_world, mat, u, v, u, v


def _unpack_rows(rows):
    """[B, W] gathered rows -> list of W [B] columns."""
    return [rows[:, c] for c in range(rows.shape[1])]


# Mesh-sized triangle tables (> gather.MAX_ONEHOT_K) exceed the one-hot
# matmul's profitable range, so the winner recompute needs real gathers.
# Thirteen separate [B]-indexed column gathers are thirteen scalar-ish
# gather loops; packing all columns into one traced [N,16] table turns them
# into ONE row gather of contiguous 64-byte rows.  The concatenate is
# differentiable (its transpose is a slice), so vertex/uv gradients still
# flow.  Trace-time switch (False = per-column Lookups).
TRI_PACKED_RECORD = True


def _triangle_gather_packed(scene, ii):
    """One [N,16] row gather for all 13 winner-triangle columns.
    Requires the identity-transform fast path (mesh scenes; the BVH builder
    enforces identity triangle transforms)."""
    packed = jnp.concatenate(
        [scene.tri_v0, scene.tri_v1, scene.tri_v2,
         scene.tri_uv0, scene.tri_uv1, scene.tri_uv2,
         scene.tri_mat.astype(scene.tri_v0.dtype)[:, None]],
        axis=1,
    )  # [N, 16]
    c = _unpack_rows(packed[ii])  # [B, 16] -> 16 x [B]
    v0 = V3(c[0], c[1], c[2])
    v1 = V3(c[3], c[4], c[5])
    v2 = V3(c[6], c[7], c[8])
    uvs = (c[9], c[10], c[11], c[12], c[13], c[14])
    mat = c[15].astype(jnp.int32)
    return v0, v1, v2, uvs, mat


def _triangle_record(scene, o, d, t, idx):
    ii = jnp.clip(idx, 0, scene.n_triangles - 1)
    packed = (
        TRI_PACKED_RECORD
        and scene.n_triangles > 512
        and _identity_xf(scene)
    )
    look = Lookup(ii, scene.n_triangles)
    if packed:
        v0, v1, v2, packed_uvs, packed_mat = _triangle_gather_packed(scene, ii)
        o_b, d_b = o, d
        rows = None
    else:
        v0 = look.v3(scene.tri_v0)
        v1 = look.v3(scene.tri_v1)
        v2 = look.v3(scene.tri_v2)
        (xf,) = look(scene.tri_xf)
        o_b, d_b, rows, _ = _ray_to_object_gathered(scene, xf, o, d)
    n = vec3.cross(v1 - v0, v2 - v0)
    # Differentiable t recompute from the plane equation.
    ndotd = vec3.dot(n, d_b)
    ok = ndotd != 0.0
    t = jnp.where(
        ok, (vec3.dot(n, v0) - vec3.dot(n, o_b)) / jnp.where(ok, ndotd, 1.0), t
    )
    p_obj = o_b + d_b * t
    n2 = vec3.length_squared(n)
    # Area-ratio barycentrics exactly as triangle.h:62-84: u weights vertex 1,
    # v weights vertex 2, (1-u-v) weights vertex 3.
    u = vec3.dot(n, vec3.cross(v2 - v1, p_obj - v1)) / n2
    v = vec3.dot(n, vec3.cross(v0 - v2, p_obj - v2)) / n2
    w = 1.0 - u - v
    if packed:
        (uv0u, uv0v, uv1u, uv1v, uv2u, uv2v) = packed_uvs
        mat = packed_mat
    else:
        (uv0u, uv0v, uv1u, uv1v, uv2u, uv2v, mat) = look(
            scene.tri_uv0[:, 0], scene.tri_uv0[:, 1],
            scene.tri_uv1[:, 0], scene.tri_uv1[:, 1],
            scene.tri_uv2[:, 0], scene.tri_uv2[:, 1],
            scene.tri_mat,
        )
    tu = u * uv0u + v * uv1u + w * uv2u
    tv = u * uv0v + v * uv1v + w * uv2v
    # DIVERGENCE from reference: normalized normal (see module docstring).
    n_world = vec3.unit(n if rows is None else vec3.rotate(rows, n))
    p_world = o + d * t
    return t, p_world, n_world, mat, u, v, tu, tv


def _medium_record(scene, o, d, t, idx, u_media, t_min):
    ii = jnp.clip(idx, 0, scene.n_media - 1)
    look = Lookup(ii, scene.n_media)
    # Differentiable t recompute: the free-flight distance is a smooth
    # function of the boundary interval and density given the (detached)
    # uniform, so gradients flow to boundary params and density.
    t1, t2, _ = _medium_interval(scene, o, d)
    # Column select instead of take_along_axis: media counts are tiny (<= 2
    # in all canonical scenes) so a masked column sum is plain elementwise
    # work, with no gather.
    if scene.n_media == 1:
        t1 = t1[:, 0]
        u = u_media[:, 0] if u_media.shape[1] else jnp.zeros_like(t)
    else:
        sel = ii[:, None] == jnp.arange(scene.n_media, dtype=ii.dtype)[None, :]
        t1 = jnp.where(sel, t1, 0.0).sum(axis=1)
        if u_media.shape[1]:
            u = jnp.where(sel, u_media, 0.0).sum(axis=1)
        else:
            u = jnp.zeros_like(t)
    r1 = jnp.maximum(jnp.maximum(t1, t_min), 0.0)
    ray_len = vec3.length(d)
    (nid, mat) = look(scene.med_neg_inv_density, scene.med_mat)
    hd = nid * jnp.log(jnp.maximum(u, 1e-37))
    t = r1 + hd / ray_len
    p_world = o + d * t
    # Arbitrary fixed normal and front_face=true (constant_medium.h:77-78).
    n = V3.full_like(t, 1.0, 0.0, 0.0)
    z = jnp.zeros_like(t)
    return t, p_world, n, mat, z, z, z, z


def make_hit_record(scene, o: V3, d: V3, time, t, kind, idx, u_media=None,
                    t_min=1e-3) -> HitRecord:
    """Reconstruct the full hit record for each ray's winning primitive.

    ``t`` is used only as a detached selection hint; each kind recomputes its
    own t differentiably, so callers may pass ``stop_gradient(t)``.
    ``t_min`` must match the value used for winner selection — the medium
    recompute clamps the boundary entry to it (constant_medium.h:57).
    """
    B = t.shape[0]
    z = jnp.zeros((B,), o.x.dtype)
    zv = V3(z, z, z)
    p, n, mat, u, v, tu, tv = zv, zv, jnp.zeros((B,), jnp.int32), z, z, z, z
    t_out = t

    def merge(cond, new):
        nonlocal t_out, p, n, mat, u, v, tu, tv
        nt, np_, nn, nm, nu, nv, ntu, ntv = new
        t_out = jnp.where(cond, nt, t_out)
        p = vec3.where(cond, np_, p)
        n = vec3.where(cond, nn, n)
        mat = jnp.where(cond, nm, mat)
        u = jnp.where(cond, nu, u)
        v = jnp.where(cond, nv, v)
        tu = jnp.where(cond, ntu, tu)
        tv = jnp.where(cond, ntv, tv)

    if scene.n_spheres:
        merge(kind == scene_lib.PRIM_SPHERE,
              _sphere_record(scene, o, d, time, t, idx))
    if scene.n_rects:
        merge(kind == scene_lib.PRIM_RECT, _rect_record(scene, o, d, t, idx))
    if scene.n_triangles:
        merge(kind == scene_lib.PRIM_TRIANGLE,
              _triangle_record(scene, o, d, t, idx))
    if scene.n_media:
        if u_media is None:
            u_media = jnp.zeros((B, scene.n_media), o.x.dtype)
        merge(kind == scene_lib.PRIM_MEDIUM,
              _medium_record(scene, o, d, t, idx, u_media, t_min))

    is_medium = kind == scene_lib.PRIM_MEDIUM
    # set_face_normal (hittable.h:18-22); media force front=true with the
    # arbitrary (1,0,0) normal.
    front = (vec3.dot(d, n) < 0.0) | is_medium
    n = vec3.where(front | is_medium, n, -n)
    return HitRecord(t=t_out, p=p, normal=n, front_face=front, mat=mat, u=u, v=v, tu=tu, tv=tv)
