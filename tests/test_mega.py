"""Megakernel (Triton route, interpret mode) vs the XLA regenerating
wavefront.

The megakernel re-derives the whole forward loop (camera, RNG, sweep,
shade, regen) with the same f32 formulas; in interpret mode the arithmetic
runs through the same XLA ops, so agreement here is tight — the only
divergence is the world-baked rect/sphere geometry (world-parallelogram
test vs object-space sweep), which is ulp-level for the canonical scenes.
The compiled kernel is compared with the same tolerance on the GPU by
chip_smoke.py and the ``gpu``-marked test below.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from another_raytracer.models import library
from another_raytracer.models.scene import SceneBuilder
from another_raytracer.ops import camera as camera_lib, integrator, vec3
from another_raytracer.ops.pallas import mega_kernel

W, H, SPP, DEPTH = 24, 18, 4, 5


def _run_both(scene, cam_params, spp=SPP, seed=3):
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    assert mega_kernel.supports(scene, cam)
    pix = jnp.arange(W * H, dtype=jnp.uint32)
    samp0 = jnp.zeros((W * H,), jnp.uint32)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=spp,
              spp_cap=spp, max_depth=DEPTH, t_min=1e-3)
    ref, ref_segs = integrator.trace_regenerative(
        scene, cam, pix, samp0, jnp.uint32(seed), **kw)
    got, got_segs = mega_kernel.trace_regenerative_mega(
        scene, cam, pix, samp0, jnp.uint32(seed), interpret=True, **kw)
    return (vec3.to_numpy(ref), int(ref_segs)), (vec3.to_numpy(got), int(got_segs))


def _check(scene, cam_params, flip_budget=0.02, **kw):
    (ref, ref_segs), (got, got_segs) = _run_both(scene, cam_params, **kw)
    # Segment counts agree to the handful of decision-boundary flips.
    assert abs(got_segs - ref_segs) <= max(4, 0.01 * ref_segs)
    diff = np.abs(got - ref)
    frac_bad = (diff > 2e-2).mean()
    assert frac_bad <= flip_budget, (
        f"{frac_bad:.2%} differ; mean={diff.mean():.2e} max={diff.max():.2e}")
    assert np.median(diff) < 1e-5


def test_cornell_box():
    scene, cam = library.cornell_box()
    _check(scene, cam)


def test_sphere_ground_metal_dielectric():
    # Lens + motion + metal + dielectric + checker in one small scene.
    b = SceneBuilder(background=(0.7, 0.8, 1.0), seed=5)
    b.sphere((0, -100.5, -1), 100,
             b.lambertian(texture=b.checker_texture((0.2, 0.3, 0.1),
                                                    (0.9, 0.9, 0.9))))
    b.sphere((0, 0, -1), 0.5, b.lambertian(color=(0.1, 0.2, 0.5)))
    b.sphere((1, 0, -1), 0.5, b.metal((0.8, 0.6, 0.2), 0.3))
    b.sphere((-1, 0, -1), 0.5, b.dielectric(1.5))
    b.moving_sphere((0, 0.8, -1), (0, 1.0, -1), 0, 1, 0.2,
                    b.lambertian(color=(0.9, 0.2, 0.2)))
    cam = dict(lookfrom=(0, 0.5, 1.5), lookat=(0, 0, -1), vfov=60.0,
               aperture=0.1, focus_dist=2.5, time0=0.0, time1=1.0)
    _check(b.build(), cam)


def test_two_spheres():
    scene, cam = library.two_spheres()
    _check(scene, cam)


def test_supports_gating():
    scene, cam_params = library.final_scene()
    cam = camera_lib.make_camera(aspect_ratio=1.0, **cam_params)
    assert not mega_kernel.supports(scene, cam)  # BVH + media + textures
    scene, cam_params = library.two_perlin_spheres()
    cam = camera_lib.make_camera(aspect_ratio=1.0, **cam_params)
    assert not mega_kernel.supports(scene, cam)  # perlin texture


def test_supports_gating_bvh():
    # A BVH'd scene is out of the kernel's class: the XLA traversal serves it.
    scene, cam_params = library.random_scene()
    cam = camera_lib.make_camera(aspect_ratio=1.0, **cam_params)
    assert scene.has_accel
    assert not mega_kernel.supports(scene, cam)


@pytest.mark.parametrize("backend,expected", [("gpu", True), ("cpu", False),
                                              ("rocm", False)])
def test_kernel_choice_by_backend(monkeypatch, backend, expected):
    # One function chooses the megakernel: only the GPU backend, only for
    # supported scenes; nothing picks the interpreter by itself.
    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    monkeypatch.setattr(mega_kernel.jax, "default_backend", lambda: backend)
    assert mega_kernel.enabled(scene, cam) is expected
    from another_raytracer.ops.pallas import mega_diff

    assert mega_diff.enabled(scene, cam, 4, 1, 4, W * H,
                             trainable=("tex_ca",)) is expected
    tex, tcp = library.two_perlin_spheres()
    tcam = camera_lib.make_camera(aspect_ratio=1.0, **tcp)
    assert mega_kernel.enabled(tex, tcam) is False


def test_interpret_defaults_off():
    import inspect

    sig = inspect.signature(mega_kernel.trace_regenerative_mega)
    assert sig.parameters["interpret"].default is False
    from another_raytracer.ops.pallas import mega_diff

    assert inspect.signature(
        mega_diff.radiance_fused).parameters["interpret"].default is False
    assert mega_diff.INTERPRET is False


@pytest.mark.parametrize("block", [0, 16, 96, 2048])
def test_rejects_bad_block(block):
    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    pix = jnp.arange(64, dtype=jnp.uint32)
    with pytest.raises(ValueError, match="power of two"):
        mega_kernel.trace_regenerative_mega(
            scene, cam, pix, pix * 0, jnp.uint32(0), width=W, height=H,
            sample_stride=1, sample_end=1, spp_cap=1, max_depth=2,
            t_min=1e-3, block=block, interpret=True)


def test_padding_and_partial_samples():
    # B not a multiple of the block: padded lanes must contribute nothing.
    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    pix = jnp.arange(W * H, dtype=jnp.uint32)
    samp0 = jnp.zeros((W * H,), jnp.uint32)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=2, spp_cap=2,
              max_depth=3, t_min=1e-3)
    a, sa = mega_kernel.trace_regenerative_mega(
        scene, cam, pix, samp0, jnp.uint32(0), interpret=True, block=256, **kw)
    b, sb = mega_kernel.trace_regenerative_mega(
        scene, cam, pix, samp0, jnp.uint32(0), interpret=True, block=128, **kw)
    np.testing.assert_allclose(vec3.to_numpy(a), vec3.to_numpy(b), atol=1e-6)
    assert int(sa) == int(sb)


@pytest.mark.parametrize("block", [32, 64, 512])
def test_padding_and_block_sizes(block):
    # B (432) is a multiple of none of these blocks: padded lanes must
    # contribute nothing, and the result must not depend on the block.
    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    pix = jnp.arange(W * H, dtype=jnp.uint32)
    samp0 = jnp.zeros((W * H,), jnp.uint32)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=2, spp_cap=2,
              max_depth=3, t_min=1e-3)
    a, sa = mega_kernel.trace_regenerative_mega(
        scene, cam, pix, samp0, jnp.uint32(0), interpret=True, block=block,
        **kw)
    b, sb = integrator.trace_regenerative(
        scene, cam, pix, samp0, jnp.uint32(0), **kw)
    assert a.x.shape == (W * H,)
    assert abs(int(sa) - int(sb)) <= 4
    diff = np.abs(vec3.to_numpy(a) - vec3.to_numpy(b))
    assert (diff > 2e-2).mean() <= 0.02
    assert np.median(diff) < 1e-5


def test_pad_pow2():
    assert mega_kernel._pad_pow2(jnp.ones(18 * 32)).shape == (1024,)
    assert mega_kernel._pad_pow2(jnp.ones(32)).shape == (32,)
    assert float(mega_kernel._pad_pow2(jnp.ones(5))[5:].sum()) == 0.0


def test_residual_layout():
    # Residual rows come back as [record_iters, B]: row `it` holds every
    # lane's code at while iteration `it`.  Rows past a lane's own chain
    # keep event 0 (dead); T_prev starts each path at (1, 1, 1); segments
    # and radiance equal the non-recording run.
    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    B = W * H
    pix = jnp.arange(B, dtype=jnp.uint32)
    samp0 = jnp.zeros((B,), jnp.uint32)
    spp, depth = 2, 3
    kw = dict(width=W, height=H, sample_stride=1, sample_end=spp,
              spp_cap=spp, max_depth=depth, t_min=1e-3, interpret=True,
              block=64)
    rad, segs = mega_kernel.trace_regenerative_mega(
        scene, cam, pix, samp0, jnp.uint32(1), **kw)
    rad2, segs2, codes, tprev = mega_kernel.trace_regenerative_mega(
        scene, cam, pix, samp0, jnp.uint32(1), record_iters=spp * depth, **kw)
    codes = np.asarray(codes)
    assert codes.shape == (spp * depth, B)
    assert tprev.x.shape == (spp * depth, B)
    assert int(segs) == int(segs2)
    np.testing.assert_array_equal(vec3.to_numpy(rad), vec3.to_numpy(rad2))
    ev = codes & 3
    end = (codes & 4) != 0
    # Iteration 0 is every lane's primary ray: a live event with T = 1.
    assert (ev[0] > 0).all()
    np.testing.assert_array_equal(np.asarray(tprev.x[0]), 1.0)
    # Each lane ends exactly spp chains (Cornell: no metal absorption).
    assert (end.sum(axis=0) == spp).all()
    # After a lane's last chain end every row is dead (event 0, no end bit).
    last = (spp * depth - 1) - np.argmax(end[::-1], axis=0)
    rows = np.arange(spp * depth)[:, None]
    assert (codes[rows > last[None, :]] == 0).all()
    # Texture ids decode into the scene's table.
    assert (codes >> 4).max() < scene.tex_kind.shape[0]


@pytest.mark.gpu
def test_compiled_kernel_matches_xla(gpu):
    # The compiled Triton kernel (no interpreter) against the XLA wavefront.
    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    pix = jnp.arange(W * H, dtype=jnp.uint32)
    samp0 = jnp.zeros((W * H,), jnp.uint32)
    kw = dict(width=W, height=H, sample_stride=1, sample_end=SPP,
              spp_cap=SPP, max_depth=DEPTH, t_min=1e-3)
    ref, rs = integrator.trace_regenerative(
        scene, cam, pix, samp0, jnp.uint32(3), **kw)
    got, gs = mega_kernel.trace_regenerative_mega(
        scene, cam, pix, samp0, jnp.uint32(3), **kw)
    assert abs(int(gs) - int(rs)) <= max(4, 0.01 * int(rs))
    diff = np.abs(vec3.to_numpy(got) - vec3.to_numpy(ref))
    assert (diff > 2e-2).mean() <= 0.02
    assert np.median(diff) < 1e-5
