"""Stackless BVH traversal on device (plain XLA).

Replaces the reference's recursive shared_ptr tree walk (bvh.cpp:44-52) with
a lockstep wavefront over the flat escape-index layout built host-side
(models/bvh.py): every ray carries its own node pointer; one
``lax.while_loop`` iteration performs the slab test (aabb.h:16-29
semantics) for all rays at once, advances hit rays into the subtree
(``i+1``) and missed rays past it (``escape[i]``), and resolves leaf hits
with up-to-leaf_size gathered primitive tests.  t_max shrinks to the best
hit so far, so subtree culling tightens as traversal proceeds.

Operates directly on the *packed* arrays ([M,8] nodes, [N+pad,16]
leaf-ordered primitive rows — models/bvh.py row formats): leaves are
contiguous row runs, so each leaf test is ONE [B,16] row gather instead of
per-column gathers, and the packed id code in slot 9 carries (within-kind
id, kind) for mixed planar trees.

The while_loop has no reverse-mode rule, but that doesn't matter: the winner
search is a detached discrete decision — ``make_hit_record`` recomputes the
winning primitive's t differentiably (ops/intersect.py), so BVH renders are
fully gradient-capable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from another_raytracer.ops.intersect import BIG
from another_raytracer.models.bvh import META_SCALE
from another_raytracer.ops.vec3 import V3


def traverse_packed(nodes, rows, o: V3, d: V3, time, t_min, init_t, init_idx,
                    *, leaf_size: int, prim: str = "planar"):
    """Closest hit via packed BVH (XLA lockstep; per-ray node cursors).

    Args:
      nodes: [M,8] packed nodes (models/bvh.pack_nodes layout).
      rows: [N+pad,16] leaf-ordered primitive rows ('planar', 'sphere' or
        'rect' format, models/bvh.py docstring).
      o, d: V3 world rays ([B] components).
      time: [B] ray times (sphere center lerp; ignored for planar).
      init_t, init_idx: running best (from other primitive kinds).
      leaf_size: must equal the build-time leaf size.

    Returns (t [B], code [B] int32 — rows slot 9 where improved, else the
    init value —, improved [B] bool).
    """
    n_nodes = nodes.shape[0]
    n_rows = rows.shape[0]
    esc_col = nodes[:, 6].astype(jnp.int32)
    meta_col = nodes[:, 7].astype(jnp.int32)

    def safe_inv(c):
        return 1.0 / jnp.where(jnp.abs(c) < 1e-20, jnp.where(c < 0, -1e-20, 1e-20), c)

    inv_d = V3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z))
    if prim == "sphere":
        a_vec = d.x * d.x + d.y * d.y + d.z * d.z
        inv_a = 1.0 / jnp.where(a_vec > 0.0, a_vec, 1.0)

    def planar_test(r, best_t):
        v0 = V3(r[:, 0], r[:, 1], r[:, 2])
        v1 = V3(r[:, 3], r[:, 4], r[:, 5])
        v2 = V3(r[:, 6], r[:, 7], r[:, 8])
        from another_raytracer.ops import vec3

        n = vec3.cross(v1 - v0, v2 - v0)
        ndotd = vec3.dot(n, d)
        ok = ndotd != 0.0
        t = jnp.where(
            ok, (vec3.dot(n, v0) - vec3.dot(n, o)) / jnp.where(ok, ndotd, 1.0), BIG
        )
        p = o + d * t
        w0 = vec3.dot(n, vec3.cross(v1 - v0, p - v0))
        w1 = vec3.dot(n, vec3.cross(v2 - v1, p - v1))
        w2 = vec3.dot(n, vec3.cross(v0 - v2, p - v2))
        valid = ok & (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (t > t_min) & (t < best_t)
        return t, valid

    def sphere_test(r, best_t):
        frac = (time - r[:, 6]) * r[:, 7]
        ocx = o.x - (r[:, 0] + frac * r[:, 3])
        ocy = o.y - (r[:, 1] + frac * r[:, 4])
        ocz = o.z - (r[:, 2] + frac * r[:, 5])
        rad = r[:, 8]
        half_b = ocx * d.x + ocy * d.y + ocz * d.z
        c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        disc = half_b * half_b - a_vec * c
        ok = disc > 0.0
        sq = jnp.sqrt(jnp.where(ok, disc, 0.0))
        root1 = (-half_b - sq) * inv_a
        root2 = (-half_b + sq) * inv_a
        r1_ok = (root1 > t_min) & (root1 < best_t)
        t = jnp.where(r1_ok, root1, root2)
        valid = ok & (t > t_min) & (t < best_t)
        return t, valid

    def rect_test(r, best_t):
        """Native axis-rect test on gathered rows ('rect' format);
        mirrors ops/intersect._rect_t exactly (aarect.cpp semantics)."""
        ax = r[:, 0]
        kk = r[:, 1]
        is0 = ax == 0.0
        is2 = ax == 2.0
        o_ax = jnp.where(is0, o.x, jnp.where(is2, o.z, o.y))
        d_ax = jnp.where(is0, d.x, jnp.where(is2, d.z, d.y))
        parallel = d_ax == 0.0
        t = jnp.where(parallel, BIG,
                      (kk - o_ax) / jnp.where(parallel, 1.0, d_ax))
        o_au = jnp.where(is0, o.y, o.x)
        d_au = jnp.where(is0, d.y, d.x)
        o_av = jnp.where(is2, o.y, o.z)
        d_av = jnp.where(is2, d.y, d.z)
        pu = o_au + t * d_au
        pv = o_av + t * d_av
        inside = (pu >= r[:, 2]) & (pu <= r[:, 4]) & \
                 (pv >= r[:, 3]) & (pv <= r[:, 5])
        valid = inside & (t > t_min) & (t < best_t) & ~parallel
        return t, valid

    prim_test = {"planar": planar_test, "sphere": sphere_test,
                 "rect": rect_test}[prim]

    def cond(state):
        i, best_t, best_i, improved = state
        return jnp.any(i < n_nodes)

    def body(state):
        i, best_t, best_i, improved = state
        active = i < n_nodes
        ii = jnp.minimum(i, n_nodes - 1)
        lo = V3(nodes[:, 0][ii], nodes[:, 1][ii], nodes[:, 2][ii])
        hi = V3(nodes[:, 3][ii], nodes[:, 4][ii], nodes[:, 5][ii])
        tA = (lo - o) * inv_d
        tB = (hi - o) * inv_d
        tn = jnp.maximum(
            jnp.maximum(jnp.minimum(tA.x, tB.x), jnp.minimum(tA.y, tB.y)),
            jnp.minimum(tA.z, tB.z),
        )
        tf = jnp.minimum(
            jnp.minimum(jnp.maximum(tA.x, tB.x), jnp.maximum(tA.y, tB.y)),
            jnp.maximum(tA.z, tB.z),
        )
        hit_box = active & (jnp.maximum(tn, t_min) < jnp.minimum(tf, best_t))

        meta = meta_col[ii]
        count = jax.lax.rem(meta, META_SCALE)
        first = jax.lax.div(meta, META_SCALE)
        is_leaf = count > 0
        do_leaf = hit_box & is_leaf
        for k in range(leaf_size):
            r = rows[jnp.minimum(first + k, n_rows - 1)]  # [B,16] row gather
            t, valid = prim_test(r, best_t)
            valid = valid & do_leaf & (k < count)
            best_i = jnp.where(valid, r[:, 9].astype(jnp.int32), best_i)
            improved = improved | valid
            best_t = jnp.where(valid, t, best_t)

        i = jnp.where(active, jnp.where(hit_box, ii + 1, esc_col[ii]), i)
        return (i, best_t, best_i, improved)

    # Node cursors and flags derived from the rays so the loop carry enters
    # with their varying-axes type under shard_map(check_vma=True).
    zi = (o.x * 0.0).astype(jnp.int32)
    state = (zi, init_t, init_idx, zi > 0)
    _, best_t, best_i, improved = jax.lax.while_loop(cond, body, state)
    return best_t, best_i, improved
