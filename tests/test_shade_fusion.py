"""Invariants for the fused emit+scatter path and the camera RNG gating.

Draw gating must be a pure compile-time optimization: because every random
draw is keyed by a per-purpose lane (ops/rng.py), skipping the lens/time
draws for cameras/scenes that cannot use them may not change a single
radiance value.  Likewise the fused emit_and_scatter must agree exactly with
the separate emitted() + scatter() evaluation.
"""

import jax.numpy as jnp
import numpy as np

from another_raytracer.config import RenderConfig
from another_raytracer.models import library
from another_raytracer.ops import camera as camera_lib
from another_raytracer.ops import integrator, intersect, render as render_lib, shade
from another_raytracer.ops.vec3 import V3


def _render(scene, cam, w=48, h=36, spp=4):
    acc, _ = render_lib.render_radiance(
        scene, cam, jnp.uint32(3), width=w, height=h, spp=spp,
        samples_per_pass=2, max_depth=4, t_min=1e-3,
    )
    return np.stack([np.asarray(acc.x), np.asarray(acc.y), np.asarray(acc.z)])


def test_camera_gating_bit_identical():
    # Cornell: pinhole camera, no moving spheres -> lens+time draws gated.
    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=4 / 3, **cam_params)
    assert not cam.has_lens and not scene.has_motion

    gated = _render(scene, cam)
    forced = _render(scene.replace(has_motion=True), cam.replace(has_lens=True))
    np.testing.assert_array_equal(gated, forced)


def test_random_scene_keeps_motion_and_lens():
    scene, cam_params = library.random_scene()
    cam = camera_lib.make_camera(aspect_ratio=4 / 3, **cam_params)
    assert scene.has_motion  # moving diffuse spheres
    assert cam.has_lens  # aperture 0.1 (scene_manager.cpp:265-272)


def test_fused_shade_matches_separate():
    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=4 / 3, **cam_params)
    old = integrator.FUSE_SHADE
    try:
        integrator.FUSE_SHADE = True
        fused = _render(scene, cam)
        integrator.FUSE_SHADE = False
        separate = _render(scene, cam)
    finally:
        integrator.FUSE_SHADE = old
    np.testing.assert_array_equal(fused, separate)


def test_emit_and_scatter_components_agree():
    # Direct unit check on a batch of synthetic hit records over the
    # Cornell material table (lambertian walls + diffuse light).
    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=4 / 3, **cam_params)
    B = 64
    px = jnp.arange(B, dtype=jnp.uint32)
    sm = jnp.zeros((B,), jnp.uint32)
    o, d, tm = camera_lib.generate_rays(cam, px, sm, 16, 4, 7)
    t, kind, idx = intersect.closest_hit(
        scene, o, d, tm, jnp.zeros((B, 0), jnp.float32), 1e-3
    )
    rec = intersect.make_hit_record(scene, o, d, tm, t, kind, idx)

    emit_f, dir_f, att_f, ok_f = shade.emit_and_scatter(scene, rec, d, px, sm, 0, 7)
    emit_s = shade.emitted(scene, rec)
    dir_s, att_s, ok_s = shade.scatter(scene, rec, d, px, sm, 0, 7)
    for a, b in [(emit_f, emit_s), (dir_f, dir_s), (att_f, att_s)]:
        if isinstance(a, V3):
            np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
            np.testing.assert_array_equal(np.asarray(a.y), np.asarray(b.y))
            np.testing.assert_array_equal(np.asarray(a.z), np.asarray(b.z))
    np.testing.assert_array_equal(np.asarray(ok_f), np.asarray(ok_s))


def test_atlas_compact_exact(monkeypatch):
    # The shade-time texel sub-compaction (a recorded perf negative, kept
    # behind shade.ATLAS_COMPACT) must be value-exact vs the full-width
    # gather — including the overflow fallback branch.
    import numpy as np

    from another_raytracer.models.scene import SceneBuilder
    from another_raytracer.ops import camera as camera_lib, shade
    from another_raytracer.ops import render as render_lib, vec3

    b = SceneBuilder(background=(0.7, 0.8, 1.0), seed=2)
    img = np.random.default_rng(0).integers(
        0, 256, size=(8, 16, 3)).astype(np.float64) / 255.0
    b.sphere((0, 0, -1), 0.5, b.lambertian(texture=b.image_texture(img)))
    b.sphere((0, -100.5, -1), 100, b.lambertian(color=(0.5, 0.5, 0.5)))
    scene = b.build()
    assert scene.atlas_exact_u8
    cam = camera_lib.make_camera(aspect_ratio=4 / 3, lookfrom=(0, 0, 1),
                                 lookat=(0, 0, -1), vfov=60.0)

    def render():
        render_lib.clear_trace_caches()
        acc, _ = render_lib.render_radiance(
            scene, cam, jnp.uint32(0), width=32, height=24, spp=4,
            samples_per_pass=1, max_depth=4, t_min=1e-3)
        return vec3.to_numpy(acc)

    monkeypatch.setattr(shade, "ATLAS_COMPACT", False)
    ref = render()
    monkeypatch.setattr(shade, "ATLAS_COMPACT", True)
    monkeypatch.setattr(shade, "ATLAS_COMPACT_MIN_B", 64)
    # generous cap: compact branch taken
    monkeypatch.setattr(shade, "ATLAS_COMPACT_DIV", 2)
    np.testing.assert_array_equal(render(), ref)
    # tiny cap: overflow fallback branch taken
    monkeypatch.setattr(shade, "ATLAS_COMPACT_DIV", 512)
    np.testing.assert_array_equal(render(), ref)
    render_lib.clear_trace_caches()
