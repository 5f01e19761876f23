"""Geometry-parameter gradients (sphere centers/radii, triangle vertices,
rect planes) vs central finite differences.

The detached-sampling estimator differentiates the winner recompute
(ops/intersect.py), so interior gradients are exact; silhouette-edge terms
are missing by construction (documented bias, grad/diff.py).  Tests use
smooth setups (no visibility change under the FD step) so FD and analytic
agree tightly, plus one sphere test with a generous tolerance that admits
the edge bias.
"""

import jax
import jax.numpy as jnp
import numpy as np

from another_raytracer.grad import diff
from another_raytracer.models.scene import SceneBuilder
from another_raytracer.ops import camera as camera_lib

W, H, SPP, DEPTH = 16, 12, 2, 2


def loss_fn(scene, cam, params, trainable, target=0.3):
    tgt = jnp.full((W * H, 3), target, jnp.float32)
    return diff.render_loss(
        params, scene, cam, tgt, jnp.uint32(0), width=W, height=H, spp=SPP,
        samples_per_pass=2, max_depth=DEPTH, t_min=1e-3,
    )


def fd_check(scene, cam, key, n_coords=3, rel_tol=0.08, eps=1e-3):
    params = {key: getattr(scene, key)}
    f = jax.jit(lambda p: loss_fn(scene, cam, p, (key,)))
    g = np.asarray(jax.jit(jax.grad(lambda p: loss_fn(scene, cam, p, (key,))))(params)[key],
                   np.float64)
    assert np.isfinite(g).all()
    base = np.asarray(params[key], np.float64)
    flat = np.abs(g).ravel()
    checked = 0
    for idx in np.argsort(flat)[::-1]:
        if flat[idx] == 0.0 or checked >= n_coords:
            break
        pert = base.ravel().copy()
        pert[idx] += eps
        lp = float(f({key: jnp.asarray(pert.reshape(base.shape), jnp.float32)}))
        pert[idx] -= 2 * eps
        lm = float(f({key: jnp.asarray(pert.reshape(base.shape), jnp.float32)}))
        fd = (lp - lm) / (2 * eps)
        an = g.ravel()[idx]
        assert abs(fd - an) <= rel_tol * max(abs(fd), abs(an), 1e-4), (key, idx, fd, an)
        checked += 1
    assert checked > 0, f"no nonzero gradient coords for {key}"


def test_triangle_vertex_grads():
    """A big textured triangle covering the view: radiance depends smoothly
    on vertex positions through the barycentric blend."""
    b = SceneBuilder(background=(0.1, 0.1, 0.1), seed=2)
    bary = b.barycentric_texture((1, 0, 0), (0, 1, 0), (0, 0, 1))
    b.triangle((-30, -30, -3), (30, -30, -3), (0, 40, -3), b.lambertian(texture=bary))
    scene = b.build()
    cam = camera_lib.make_camera(lookfrom=(0, 0, 2), lookat=(0, 0, -3), vfov=50,
                                 aspect_ratio=W / H)
    fd_check(scene, cam, "tri_v2", rel_tol=0.05)
    fd_check(scene, cam, "tri_v0", rel_tol=0.05)


def test_rect_plane_grad():
    """Perlin-textured full-view wall: moving the plane shifts the (smooth)
    noise pattern, so radiance depends smoothly on rect_k.  (A checker would
    NOT work: its sign pattern has zero gradient almost everywhere.)"""
    b = SceneBuilder(background=(0.0, 0.0, 0.0), seed=3)
    noise = b.noise_texture(1.7)
    b.xy_rect(-50, 50, -50, 50, -4, b.lambertian(texture=noise))
    b.xz_rect(-50, 50, -50, 50, 8, b.diffuse_light(color=(2, 2, 2)))
    scene = b.build()
    cam = camera_lib.make_camera(lookfrom=(0.21, 0.13, 2), lookat=(0.2, 0.1, -4),
                                 vfov=50, aspect_ratio=W / H)
    fd_check(scene, cam, "rect_k", n_coords=1, rel_tol=0.08)


def test_sphere_center_and_radius_grads():
    """Sphere grads carry silhouette bias; verify interior coords agree
    within a loose tolerance and all grads are finite."""
    b = SceneBuilder(background=(0.5, 0.6, 0.8), seed=4)
    noise = b.noise_texture(2.3)
    b.sphere((0, 0, -2), 2.5, b.lambertian(texture=noise))
    scene = b.build()
    cam = camera_lib.make_camera(lookfrom=(0, 0, 1), lookat=(0, 0, -2), vfov=40,
                                 aspect_ratio=W / H)
    # radius 2.5 at distance 3 (angular radius 56 deg) vs a 33 deg frame
    # diagonal: the silhouette is fully outside the image, so geometry grads
    # have no edge bias and should match FD well.
    fd_check(scene, cam, "sph_c0", rel_tol=0.15)
    fd_check(scene, cam, "sph_r", n_coords=1, rel_tol=0.15)
