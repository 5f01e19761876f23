"""Generalized BVH acceleration (rects + spheres) vs the linear sweeps.

The reference BVHs its random-scene spheres and the final scene's ground
boxes / sphere cluster (scene_manager.cpp:61,176,231); here those kinds
resolve through packed BVHs (planar quad-triangles / native rects /
world-baked sphere tree — models/bvh.py row formats) while the hit record is
still recomputed from the original primitive parameterization.  These tests
pin winner-level equivalence of the XLA traversal (ops/bvh.py) against the
sweep.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from another_raytracer.models.scene import SceneBuilder
from another_raytracer.ops import intersect
from another_raytracer.ops.vec3 import V3


def _mixed_scene(**build_kw):
    """100 spheres (moving, transformed, negative-radius) + 80 rects (some
    rotated+translated) — every bake path the accelerator supports."""
    r = np.random.default_rng(7)
    b = SceneBuilder(background=(0.5, 0.6, 0.7), seed=1)
    m = b.lambertian(color=(0.5, 0.5, 0.5))
    xf = b.transform(rotate_y_deg=30.0, translate=(1.0, 0.5, -2.0))
    for i in range(100):
        c = r.uniform(-5, 5, 3)
        if i % 7 == 0:
            b.moving_sphere(c, c + r.uniform(-0.5, 0.5, 3), 0.0, 1.0, 0.4, m,
                            xform=(xf if i % 14 == 0 else 0))
        elif i % 11 == 0:
            b.sphere(c, -0.4, m, xform=xf)  # hollow-dielectric-style r < 0
        else:
            b.sphere(c, 0.4, m, xform=(xf if i % 3 == 0 else 0))
    for i in range(80):
        k = r.uniform(-5, 5)
        lo = r.uniform(-5, 0, 2)
        hi = lo + r.uniform(0.5, 3, 2)
        [b.yz_rect, b.xz_rect, b.xy_rect][i % 3](
            lo[0], hi[0], lo[1], hi[1], k, m, xform=(xf if i % 4 == 0 else 0))
    return b.build(**build_kw)


def _rays(B=8192, seed=42):
    r = np.random.default_rng(seed)
    o = V3.from_array(jnp.asarray(r.uniform(-8, 8, (B, 3)), jnp.float32))
    d = V3.from_array(jnp.asarray(r.normal(size=(B, 3)), jnp.float32))
    time = jnp.asarray(r.uniform(0, 1, B), jnp.float32)
    return o, d, time, jnp.zeros((B, 0))


def _winners(scene, o, d, time, um):
    t, k, i = intersect.closest_hit(scene, o, d, time, um, 1e-3)
    return np.asarray(t), np.asarray(k), np.asarray(i)


def test_accel_matches_sweep():
    lin = _mixed_scene(bvh=False, rect_bvh=False, sphere_bvh=False)
    acc = _mixed_scene(bvh=False, rect_bvh=True, sphere_bvh=True)
    assert not lin.has_accel
    assert acc.rect_in_bvh and acc.sph_in_bvh
    assert acc.n_bvh_nodes > 0 and acc.n_sph_bvh_nodes > 0

    o, d, time, um = _rays()
    t1, k1, i1 = _winners(lin, o, d, time, um)
    t2, k2, i2 = _winners(acc, o, d, time, um)

    np.testing.assert_array_equal(k1, k2)
    hit = k1 >= 0
    np.testing.assert_array_equal(i1[hit], i2[hit])
    # World-baked arithmetic vs the object-space sweep: same math, different
    # f32 rounding (the winner's t is recomputed differentiably either way).
    np.testing.assert_allclose(t1[hit], t2[hit], rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("prim", ["planar", "rect", "sphere"])
def test_traverse_packed_matches_linear_sweep(prim):
    """ops/bvh.traverse_packed on one packed tree against a brute-force
    test of every packed row (same row arithmetic, no tree): identical
    winners and t.  Spheres include moving ones (time lerp)."""
    from another_raytracer.ops import bvh as bvh_ops

    acc = _mixed_scene(bvh=False, rect_bvh=True, sphere_bvh=True)
    nodes, rows = {
        "planar": (acc.bvh_packed_nodes, acc.bvh_packed_tris),
        "rect": (acc.rect_bvh_nodes, acc.rect_bvh_rows),
        "sphere": (acc.sph_bvh_nodes, acc.sph_bvh_rows),
    }[prim]
    assert nodes.shape[0] > 1
    o, d, time, _ = _rays(B=2048, seed=3)
    B = o.x.shape[0]
    init_t = jnp.full((B,), intersect.BIG, jnp.float32)
    init_i = jnp.full((B,), -1, jnp.int32)
    t_bvh, c_bvh, h_bvh = bvh_ops.traverse_packed(
        nodes, rows, o, d, time, 1e-3, init_t, init_i,
        leaf_size=acc.bvh_leaf_size, prim=prim)

    # Brute force: a one-node tree whose single leaf holds every row.
    n_rows = int(rows.shape[0])
    t_lin, c_lin, h_lin = init_t, init_i, jnp.zeros((B,), bool)
    for first in range(0, n_rows, acc.bvh_leaf_size):
        count = min(acc.bvh_leaf_size, n_rows - first)
        flat = np.array([[-1e9, -1e9, -1e9, 1e9, 1e9, 1e9, 1.0,
                          first * 64 + count]], np.float32)
        t_lin, c_lin, h = bvh_ops.traverse_packed(
            jnp.asarray(flat), rows, o, d, time, 1e-3, t_lin, c_lin,
            leaf_size=acc.bvh_leaf_size, prim=prim)
        h_lin = h_lin | h
    h_bvh, h_lin = np.asarray(h_bvh), np.asarray(h_lin)
    np.testing.assert_array_equal(h_bvh, h_lin)
    assert h_bvh.mean() > 0.05, prim  # the rays do hit this tree
    np.testing.assert_array_equal(np.asarray(c_bvh)[h_bvh],
                                  np.asarray(c_lin)[h_lin])
    np.testing.assert_allclose(np.asarray(t_bvh)[h_bvh],
                               np.asarray(t_lin)[h_lin], rtol=1e-6)


def test_final_scene_uses_accel_and_renders():
    """The final scene's 2,401 rects + 1,006 spheres route through BVHs and
    still render non-black (structure-level gate; oracle parity covers the
    image in test_vs_oracle.py)."""
    from another_raytracer.models import library
    from another_raytracer.ops import camera as camera_lib
    from another_raytracer.ops import render as render_lib
    from another_raytracer.config import RenderConfig

    scene, cp = library.final_scene()
    assert scene.rect_in_bvh and scene.sph_in_bvh
    # All final-scene rects are identity-transform -> native rect tree; the
    # planar (quad) tree only exists for transformed rects / triangles.
    assert scene.n_rect_bvh_nodes > 0 and scene.n_sph_bvh_nodes > 0
    assert scene.n_bvh_nodes == 0
    cam = camera_lib.make_camera(aspect_ratio=1.0, **cp)
    cfg = RenderConfig(width=24, height=24, samples_per_pixel=2, max_depth=4)
    img, _ = render_lib.render(scene, cam, cfg)
    assert img.max() > 0


def test_flat_rect_boxes_are_hittable():
    """Axis-aligned rects have zero-thickness AABBs; the builder pads them
    (models/bvh.pad_flat) so the strict slab test still admits in-plane
    boxes — the reference pads rect boxes the same way (aarect.h)."""
    b = SceneBuilder(seed=1)
    m = b.lambertian(color=(0.5, 0.5, 0.5))
    for i in range(70):  # above RECT_BVH_THRESHOLD
        b.xz_rect(-1 + 0.01 * i, 1 + 0.01 * i, -1, 1, 0.0, m)
    scene = b.build()
    assert scene.rect_in_bvh
    B = 64
    o = V3.full_like(jnp.zeros((B,)), 0.0, 5.0, 0.0)
    d = V3.full_like(jnp.zeros((B,)), 0.0, -1.0, 0.0)
    t, k, i = intersect.closest_hit(
        scene, o, d, jnp.zeros((B,)), jnp.zeros((B, 0)), 1e-3)
    assert bool((np.asarray(k) == 1).all())
    np.testing.assert_allclose(np.asarray(t), 5.0, rtol=1e-6)
