"""Fused differentiable path (megakernel primal in the Pallas interpreter +
replay backward) vs XLA autodiff through the lockstep scan.

The replay backward claims EXACT shading-parameter gradients for the
lambertian/light + solid scene class; these tests hold it to that against
jax's autodiff of the scan path on the Cornell box.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from another_raytracer.models import library
from another_raytracer.ops import camera as camera_lib, vec3
from another_raytracer.ops import render as render_lib
from another_raytracer.ops.pallas import mega_diff

W, H, SPP, DEPTH = 16, 12, 4, 4
NL = W * H  # lanes of one render at samples_per_pass=1


def _force(fused):
    """Set the fused-path switch; forcing it on runs the interpreter."""
    mega_diff.FUSED_DIFF = fused
    mega_diff.INTERPRET = fused is True


def _reset():
    mega_diff.FUSED_DIFF = None
    mega_diff.INTERPRET = False


@pytest.fixture
def cornell():
    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    return scene, cam


def _grads_through_render(scene, cam, w):
    def loss(ca, bgp):
        s = scene.replace(tex_ca=ca, background=bgp)
        acc, _ = render_lib.render_radiance(
            s, cam, jnp.uint32(5), width=W, height=H, spp=SPP,
            samples_per_pass=1, max_depth=DEPTH, t_min=1e-3,
            differentiable=True)
        return (jnp.sum(acc.x * w[:, 0]) + jnp.sum(acc.y * w[:, 1])
                + jnp.sum(acc.z * w[:, 2]))

    val, grads = jax.value_and_grad(loss, argnums=(0, 1))(
        scene.tex_ca, scene.background)
    return float(val), tuple(np.asarray(g) for g in grads)


def _value_and_grads(scene, cam, fused, w):
    _force(fused)
    render_lib.clear_trace_caches()
    try:
        return _grads_through_render(scene, cam, w)
    finally:
        _reset()
        render_lib.clear_trace_caches()


def test_supports(cornell):
    scene, cam = cornell
    assert mega_diff.supports_diff(scene, cam, SPP, 1, DEPTH, NL)
    tex_scene, cp = library.two_perlin_spheres()
    tcam = camera_lib.make_camera(aspect_ratio=1.0, **cp)
    assert not mega_diff.supports_diff(tex_scene, tcam, SPP, 1, DEPTH, NL)
    # residual bound: 100 spp x depth 50 at 720x540 lanes
    assert not mega_diff.supports_diff(scene, cam, 100, 1, 50, 720 * 540)


def test_geometry_trainable_gate(cornell):
    # The fused path zeroes geometry cotangents by construction; the gate
    # must never auto-engage for a geometry-trainable (or undeclared)
    # trainable set, and forced mode must raise rather than silently zero.
    scene, cam = cornell
    assert mega_diff.supports_diff(scene, cam, SPP, 1, DEPTH, NL)
    # Auto mode: shading-only trainable set may engage (on the GPU); a
    # geometry leaf or an undeclared set never does.
    assert not mega_diff.enabled(scene, cam, SPP, 1, DEPTH, NL,
                                 trainable=("tex_ca", "sph_c0"))
    assert not mega_diff.enabled(scene, cam, SPP, 1, DEPTH, NL,
                                 trainable=None)
    # Absent-kind geometry (no triangles in the supported class) is safe.
    assert (mega_diff.enabled(scene, cam, SPP, 1, DEPTH, NL,
                              trainable=("tex_ca", "tri_v0"))
            == mega_diff.enabled(scene, cam, SPP, 1, DEPTH, NL,
                                 trainable=("tex_ca",)))
    mega_diff.FUSED_DIFF = True
    try:
        with pytest.raises(ValueError, match="geometry"):
            mega_diff.enabled(scene, cam, SPP, 1, DEPTH, NL,
                              trainable=("tex_ca", "sph_c0"))
        assert mega_diff.enabled(scene, cam, SPP, 1, DEPTH, NL,
                                 trainable=("tex_ca", "background"))
    finally:
        _reset()
    # End to end: render_loss threads its trainable set into the gate, so
    # a geometry-trainable run with the fused path FORCED raises instead
    # of silently returning zero geometry cotangents.  (Within the
    # supported scene class the detached estimator's true geometry
    # gradient is zero a.e. anyway — solid/checker textures are piecewise
    # constant in the hit point — but the gate must not rely on that.)
    from another_raytracer.grad import diff

    params, _ = diff.split_params(scene, ("tex_ca", "rect_k"))
    target = jnp.zeros((W * H, 3), jnp.float32)
    _force(True)
    render_lib.clear_trace_caches()
    try:
        with pytest.raises(ValueError, match="geometry"):
            jax.value_and_grad(diff.render_loss)(
                params, scene, cam, target, jnp.uint32(0), width=W, height=H,
                spp=SPP, samples_per_pass=1, max_depth=DEPTH, t_min=1e-3)
    finally:
        _reset()
        render_lib.clear_trace_caches()


def test_record_iters_budget(cornell):
    # The residuals ([iters, B] codes + 3 T_prev channels, 16 B per entry)
    # live in device memory between forward and backward; supports_diff
    # must refuse configs whose residual bytes exceed MAX_RESIDUAL_BYTES.
    scene, cam = cornell
    assert mega_diff.residual_bytes(16, 1, 8, 97200) == 16 * 128 * 97200
    assert mega_diff.residual_bytes(16, 4, 8, 100) == 16 * 4 * 8 * 100
    budget = mega_diff.MAX_RESIDUAL_BYTES
    lanes_at_budget = budget // (16 * SPP * DEPTH)
    assert mega_diff.supports_diff(scene, cam, SPP, 1, DEPTH, lanes_at_budget)
    assert not mega_diff.supports_diff(scene, cam, SPP, 1, DEPTH,
                                       lanes_at_budget + 1)
    # The phase-3 training size (Cornell 360x270 spp16 depth8) fits.
    assert mega_diff.supports_diff(scene, cam, 16, 1, 8, 360 * 270)


def test_grads_match_autodiff(cornell):
    scene, cam = cornell
    # A fixed, non-uniform cotangent so every lane contributes differently.
    w = jnp.asarray(
        np.random.default_rng(0).uniform(0.2, 1.0, (W * H, 3)), jnp.float32)
    v_ref, (gca_ref, gbg_ref) = _value_and_grads(scene, cam, False, w)
    v_fus, (gca_fus, gbg_fus) = _value_and_grads(scene, cam, True, w)

    # Primal: ulp-level divergence only (interpret mode = same XLA ops).
    np.testing.assert_allclose(v_fus, v_ref, rtol=1e-5)
    # Gradients: the replay formula vs autodiff through the scan.
    scale = np.abs(gca_ref).max()
    np.testing.assert_allclose(gca_fus, gca_ref, atol=2e-4 * scale, rtol=2e-4)
    np.testing.assert_allclose(gbg_fus, gbg_ref, atol=2e-4 * max(1e-9, np.abs(gbg_ref).max()),
                               rtol=2e-4)
    # And they are non-trivial.
    assert np.abs(gca_ref).max() > 0


def test_radiance_matches_forward(cornell):
    scene, cam = cornell
    _force(True)
    render_lib.clear_trace_caches()
    try:
        acc_f, segs_f = render_lib.render_radiance(
            scene, cam, jnp.uint32(5), width=W, height=H, spp=SPP,
            samples_per_pass=1, max_depth=DEPTH, t_min=1e-3,
            differentiable=True)
    finally:
        _reset()
        render_lib.clear_trace_caches()
    acc_r, segs_r = render_lib.render_radiance(
        scene, cam, jnp.uint32(5), width=W, height=H, spp=SPP,
        samples_per_pass=1, max_depth=DEPTH, t_min=1e-3, differentiable=True)
    np.testing.assert_allclose(vec3.to_numpy(acc_f), vec3.to_numpy(acc_r),
                               atol=2e-5, rtol=2e-5)
    assert abs(int(segs_f) - int(segs_r)) <= max(4, 0.01 * int(segs_r))


def test_metal_dielectric_grads_match_autodiff():
    # Metal scatters route albedo cotangents like
    # lambertian, dielectric scatters multiply by (1,1,1) via the sentinel
    # tid, metal absorption ends the chain at value zero.  fuzz/ir
    # gradients are exactly zero under the detached estimator for
    # solid-texture scenes (verified against XLA autodiff below).
    from another_raytracer.models.scene import SceneBuilder

    b = SceneBuilder(background=(0.7, 0.8, 1.0), seed=2)
    b.sphere((0, -100.5, -1), 100, b.lambertian(color=(0.8, 0.8, 0.0)))
    b.sphere((0, 0, -1), 0.5, b.lambertian(color=(0.1, 0.2, 0.5)))
    b.sphere((-1, 0, -1), 0.5, b.dielectric(1.5))
    b.sphere((1, 0, -1), 0.5, b.metal(color=(0.8, 0.6, 0.2), fuzz=0.4))
    scene = b.build()
    cam = camera_lib.make_camera(lookfrom=(0, 0, 0), lookat=(0, 0, -1),
                                 vfov=90, aspect_ratio=W / H)
    assert mega_diff.supports_diff(scene, cam, SPP, 1, DEPTH, NL)
    w = jnp.asarray(
        np.random.default_rng(3).uniform(0.2, 1.0, (W * H, 3)), jnp.float32)

    def grads(fused):
        _force(fused)
        render_lib.clear_trace_caches()
        try:
            def loss(ca, bgp, fz, ir):
                s = scene.replace(tex_ca=ca, background=bgp, mat_fuzz=fz,
                                  mat_ir=ir)
                acc, _ = render_lib.render_radiance(
                    s, cam, jnp.uint32(5), width=W, height=H, spp=SPP,
                    samples_per_pass=1, max_depth=DEPTH, t_min=1e-3,
                    differentiable=True)
                return (jnp.sum(acc.x * w[:, 0]) + jnp.sum(acc.y * w[:, 1])
                        + jnp.sum(acc.z * w[:, 2]))

            return tuple(np.asarray(g) for g in jax.grad(
                loss, argnums=(0, 1, 2, 3))(
                    scene.tex_ca, scene.background, scene.mat_fuzz,
                    scene.mat_ir))
        finally:
            _reset()
            render_lib.clear_trace_caches()

    ref = grads(False)
    fus = grads(True)
    for g_ref, g_fus in zip(ref[:2], fus[:2]):
        scale = max(np.abs(g_ref).max(), 1e-9)
        np.testing.assert_allclose(g_fus, g_ref, atol=3e-4 * scale, rtol=3e-4)
    assert np.abs(ref[0]).max() > 0  # metal albedo grads flow
    # fuzz/ir: both paths agree the detached-estimator gradient is zero.
    assert np.abs(ref[2]).max() == 0 and np.abs(fus[2]).max() == 0
    assert np.abs(ref[3]).max() == 0 and np.abs(fus[3]).max() == 0


def test_bvh_large_t_grads_match_autodiff():
    # Sweep scenes with more than MAX_TEXTURES textures take the LARGE-T
    # replay (per-iteration albedo gathered once outside the scan;
    # cotangents scatter-added into [T+1] tables).  Grads must match XLA
    # autodiff through the scan path.
    from another_raytracer.models.scene import SceneBuilder

    rng = np.random.default_rng(9)
    b = SceneBuilder(background=(0.7, 0.8, 1.0), seed=5)
    ground = b.lambertian(texture=b.checker_texture((0.2, 0.3, 0.1),
                                                    (0.9, 0.9, 0.9)))
    b.sphere((0, -1000, 0), 1000, ground)
    for i in range(24):
        c = (rng.uniform(-5, 5), rng.uniform(0.2, 0.5), rng.uniform(-5, 2))
        if i % 9 == 0:
            b.sphere(c, 0.45, b.metal(color=tuple(rng.uniform(0.5, 1, 3)),
                                      fuzz=rng.uniform(0, 0.4)))
        elif i % 9 == 1:
            b.sphere(c, 0.45, b.dielectric(1.5))
        elif i % 7 == 0:
            b.moving_sphere(c, (c[0], c[1] + 0.3, c[2]), 0.0, 1.0, 0.4,
                            b.lambertian(color=tuple(rng.uniform(0, 1, 3))))
        else:
            b.sphere(c, 0.45,
                     b.lambertian(color=tuple(rng.uniform(0, 1, 3))))
    scene = b.build()
    assert not scene.has_accel  # a sweep scene, the kernel's class
    assert scene.tex_kind.shape[0] > mega_diff.MAX_TEXTURES  # large-T path
    cam = camera_lib.make_camera(
        lookfrom=(8, 2, 3), lookat=(0, 0.3, -1), vfov=25,
        aspect_ratio=W / H, time0=0.0, time1=1.0)
    assert mega_diff.supports_diff(scene, cam, SPP, 1, DEPTH, NL)
    w = jnp.asarray(
        np.random.default_rng(4).uniform(0.2, 1.0, (W * H, 3)), jnp.float32)

    def grads(fused):
        _force(fused)
        render_lib.clear_trace_caches()
        try:
            def loss(ca, cbp, bgp):
                s = scene.replace(tex_ca=ca, tex_cb=cbp, background=bgp)
                acc, _ = render_lib.render_radiance(
                    s, cam, jnp.uint32(5), width=W, height=H, spp=SPP,
                    samples_per_pass=1, max_depth=DEPTH, t_min=1e-3,
                    differentiable=True)
                return (jnp.sum(acc.x * w[:, 0]) + jnp.sum(acc.y * w[:, 1])
                        + jnp.sum(acc.z * w[:, 2]))

            return tuple(np.asarray(g) for g in jax.grad(
                loss, argnums=(0, 1, 2))(scene.tex_ca, scene.tex_cb,
                                         scene.background))
        finally:
            _reset()
            render_lib.clear_trace_caches()

    ref = grads(False)
    fus = grads(True)
    for g_ref, g_fus in zip(ref, fus):
        scale = max(np.abs(g_ref).max(), 1e-9)
        np.testing.assert_allclose(g_fus, g_ref, atol=3e-4 * scale, rtol=3e-4)
    assert np.abs(ref[0]).max() > 0
    assert np.abs(ref[1]).max() > 0  # checker odd-cell routing


def test_checker_grads_match_autodiff():
    # Checker textures route albedo cotangents to tex_ca/tex_cb by the
    # recorded odd-cell bit; hold the replay to autodiff on a two-spheres
    # style checker scene (lambertian only, sky background).
    scene, cam_params = library.two_spheres()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    assert mega_diff.supports_diff(scene, cam, SPP, 1, DEPTH, NL)
    w = jnp.asarray(
        np.random.default_rng(1).uniform(0.2, 1.0, (W * H, 3)), jnp.float32)

    def grads(fused):
        _force(fused)
        render_lib.clear_trace_caches()
        try:
            def loss(ca, cbp, bgp):
                s = scene.replace(tex_ca=ca, tex_cb=cbp, background=bgp)
                acc, _ = render_lib.render_radiance(
                    s, cam, jnp.uint32(5), width=W, height=H, spp=SPP,
                    samples_per_pass=1, max_depth=DEPTH, t_min=1e-3,
                    differentiable=True)
                return (jnp.sum(acc.x * w[:, 0]) + jnp.sum(acc.y * w[:, 1])
                        + jnp.sum(acc.z * w[:, 2]))

            return tuple(np.asarray(g) for g in jax.grad(
                loss, argnums=(0, 1, 2))(scene.tex_ca, scene.tex_cb,
                                         scene.background))
        finally:
            _reset()
            render_lib.clear_trace_caches()

    ref = grads(False)
    fus = grads(True)
    for g_ref, g_fus in zip(ref, fus):
        scale = max(np.abs(g_ref).max(), 1e-9)
        np.testing.assert_allclose(g_fus, g_ref, atol=3e-4 * scale, rtol=3e-4)
    assert np.abs(ref[1]).max() > 0  # tex_cb gradient is non-trivial


def test_fused_off_with_lane_mask(cornell, monkeypatch):
    # The fused branch traces every lane, so a caller's lane mask (padding
    # lanes that must contribute nothing) keeps the autodiff path.
    scene, cam = cornell
    calls = []
    monkeypatch.setattr(mega_diff, "radiance_fused",
                        lambda *a, **k: calls.append(1))
    _force(True)
    try:
        pix = jnp.arange(W * H, dtype=jnp.uint32)
        mask = pix < (W * H // 2)
        acc, _ = render_lib.radiance_batch(
            scene, cam, pix, jnp.uint32(5), width=W, height=H,
            sample_start=0, n_samples=SPP, spp_cap=SPP, samples_per_pass=1,
            max_depth=DEPTH, t_min=1e-3, differentiable=True,
            trainable=("tex_ca",), lane_mask=mask)
    finally:
        _reset()
    assert not calls
    assert float(jnp.abs(acc.x[W * H // 2:]).max()) == 0.0


@pytest.mark.gpu
def test_compiled_fused_grads_match_autodiff(cornell, gpu):
    # The compiled kernel as the fused primal (no interpreter), against XLA
    # autodiff; tolerances as in test_grads_match_autodiff.
    scene, cam = cornell
    w = jnp.asarray(
        np.random.default_rng(0).uniform(0.2, 1.0, (W * H, 3)), jnp.float32)
    v_ref, (gca_ref, gbg_ref) = _value_and_grads(scene, cam, False, w)
    mega_diff.FUSED_DIFF = True  # compiled: INTERPRET stays False
    render_lib.clear_trace_caches()
    try:
        v_fus, (gca_fus, gbg_fus) = _grads_through_render(scene, cam, w)
    finally:
        _reset()
        render_lib.clear_trace_caches()
    np.testing.assert_allclose(v_fus, v_ref, rtol=1e-5)
    scale = np.abs(gca_ref).max()
    np.testing.assert_allclose(gca_fus, gca_ref, atol=2e-4 * scale, rtol=2e-4)
    np.testing.assert_allclose(
        gbg_fus, gbg_ref, atol=2e-4 * max(1e-9, np.abs(gbg_ref).max()),
        rtol=2e-4)
