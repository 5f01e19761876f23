"""Differentiable rendering: gradients vs central finite differences.

Validates the detached-sampling estimator for shading/material parameters
(albedo texture colors, fuzz, IOR, emission) on a fixed-seed low-spp render
— the BASELINE.md gradient contract.
"""

import jax
import jax.numpy as jnp
import numpy as np

from another_raytracer.grad import diff
from another_raytracer.models.scene import SceneBuilder
from another_raytracer.ops import camera as camera_lib

W, H, SPP, DEPTH = 24, 16, 4, 4


def build_scene():
    b = SceneBuilder(background=(0.6, 0.7, 0.9), seed=2)
    b.sphere((0, -100.5, -1), 100, b.lambertian(color=(0.6, 0.6, 0.2)))
    b.sphere((0, 0, -1), 0.5, b.lambertian(color=(0.3, 0.2, 0.7)))
    b.sphere((1, 0, -1), 0.4, b.metal((0.8, 0.7, 0.6), 0.2))
    b.sphere((-1, 0, -1), 0.4, b.dielectric(1.5))
    b.sphere((0.2, 0.9, -1.2), 0.3, b.diffuse_light(color=(3, 3, 3)))
    cam = dict(lookfrom=(0, 0.4, 1.2), lookat=(0, 0, -1), vfov=60.0)
    return b.build(), cam


def loss_for(scene, cam, params, target):
    return diff.render_loss(
        params, scene, cam, target, jnp.uint32(0), width=W, height=H, spp=SPP,
        samples_per_pass=2, max_depth=DEPTH, t_min=1e-3,
    )


def test_grads_match_finite_differences():
    scene, cam_params = build_scene()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    target = jnp.zeros((W * H, 3), jnp.float32) + 0.3

    params, _ = diff.split_params(scene, trainable=("tex_ca", "mat_fuzz", "mat_ir"))
    loss_fn = jax.jit(lambda p: loss_for(scene, cam, p, target))
    grads = jax.jit(jax.grad(lambda p: loss_for(scene, cam, p, target)))(params)

    rng = np.random.default_rng(0)
    for key in params:
        g = np.asarray(grads[key], np.float64)
        assert np.isfinite(g).all(), key
        # check a few of the largest-gradient coordinates by central FD
        flat = np.abs(g).ravel()
        take = np.argsort(flat)[-3:]
        for idx in take:
            if flat[idx] == 0.0:
                continue
            eps = 1e-3
            base = np.asarray(params[key], np.float64).copy()
            pert = base.ravel().copy()
            pert[idx] = base.ravel()[idx] + eps
            pp = dict(params, **{key: jnp.asarray(pert.reshape(base.shape), jnp.float32)})
            lp = float(loss_fn(pp))
            pert[idx] = base.ravel()[idx] - eps
            pm = dict(params, **{key: jnp.asarray(pert.reshape(base.shape), jnp.float32)})
            lm = float(loss_fn(pm))
            fd = (lp - lm) / (2 * eps)
            an = g.ravel()[idx]
            # f32 render + FD truncation: generous relative tolerance.
            assert abs(fd - an) <= 0.08 * max(abs(fd), abs(an), 1e-3), (
                key, idx, fd, an
            )


def test_train_step_reduces_loss():
    scene, cam_params = build_scene()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    # Target: the same scene with a different albedo on the center sphere.
    target_scene = scene.replace(
        tex_ca=scene.tex_ca.at[1].set(jnp.array([0.9, 0.1, 0.1]))
    )
    from another_raytracer.ops import render as render_lib
    acc, _ = render_lib.render_radiance(
        target_scene, cam, jnp.uint32(0), width=W, height=H, spp=SPP,
        samples_per_pass=2, max_depth=DEPTH, t_min=1e-3,
    )
    from another_raytracer.ops import vec3
    target = jnp.asarray(vec3.to_numpy(acc) / SPP)

    state, step = diff.make_train_step(
        scene, cam, target, width=W, height=H, spp=SPP, samples_per_pass=2,
        max_depth=DEPTH, learning_rate=5e-2, trainable=("tex_ca",),
    )
    losses = []
    for i in range(10):
        state, loss = step(state, jnp.uint32(0))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.5, losses
