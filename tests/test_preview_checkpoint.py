"""Progressive preview snapshots + checkpoint/resume exactness."""

import numpy as np
import jax.numpy as jnp

from another_raytracer.config import RenderConfig
from another_raytracer.models.scene import SceneBuilder
from another_raytracer.ops import camera as camera_lib
from another_raytracer.utils import preview as preview_lib

W, H = 24, 12


def scene_and_cam():
    b = SceneBuilder(background=(0.6, 0.7, 0.9), seed=4)
    b.sphere((0, -100.5, -1), 100, b.lambertian(color=(0.4, 0.7, 0.3)))
    b.sphere((0, 0, -1), 0.5, b.metal((0.8, 0.8, 0.8), 0.1))
    cam = camera_lib.make_camera(lookfrom=(0, 0, 1), lookat=(0, 0, -1),
                                 vfov=60, aspect_ratio=W / H)
    return b.build(), cam


def test_progressive_matches_fused_and_resumes(tmp_path):
    scene, cam = scene_and_cam()
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=8, max_depth=4,
                       samples_per_pass=2, seed=3)

    from another_raytracer.ops import render as render_lib
    from another_raytracer.ops import vec3
    from another_raytracer.ops import color as color_lib
    acc, _ = render_lib.render_radiance(
        scene, cam, jnp.uint32(3), width=W, height=H, spp=8,
        samples_per_pass=2, max_depth=4, t_min=1e-3,
    )
    fused_img = np.asarray(color_lib.to_uint8(vec3.to_numpy(acc), 8)).reshape(H, W, 3)

    png = tmp_path / "preview.png"
    ckpt = preview_lib.RenderCheckpoint(str(tmp_path / "state.ckpt"))
    prev = preview_lib.ProgressivePreview(str(png), W, H)
    img, stats = preview_lib.render_progressive(scene, cam, cfg, prev, ckpt)
    assert png.exists()
    np.testing.assert_array_equal(img, fused_img)
    assert stats["resumed_at_chunk"] == 0

    # Simulate an interrupted run: rewind the checkpoint to half done, then
    # resume — result must be identical (counter-based RNG).
    state = ckpt.load()
    ckpt.save(state["radiance"] * 0.0, 0, cfg.seed, W, H)  # fresh
    half = preview_lib.RenderCheckpoint(str(tmp_path / "half.ckpt"))
    # run only first 2 of 4 chunks by capping spp, save as half checkpoint
    cfg_half = cfg.replace(samples_per_pixel=4)
    img_half, _ = preview_lib.render_progressive(scene, cam, cfg_half, None, half)
    s = half.load()
    assert int(s["samples_done"]) == 4
    # Turn the half-run state into a checkpoint for the full config and
    # resume.  spp is excluded from the fingerprint by design (extending a
    # render is the same sample stream), so the half-run fingerprint is valid
    # for the full config.
    fp = preview_lib.render_fingerprint(scene, cam, cfg)
    assert fp == preview_lib.render_fingerprint(scene, cam, cfg_half)
    full_ckpt = preview_lib.RenderCheckpoint(str(tmp_path / "full.ckpt"))
    full_ckpt.save(s["radiance"], 4, cfg.seed, W, H, fingerprint=fp)
    img2, stats2 = preview_lib.render_progressive(scene, cam, cfg, None, full_ckpt)
    assert stats2["resumed_at_chunk"] == 2
    np.testing.assert_array_equal(img2, fused_img)


def test_checkpoint_fingerprint_rejects_foreign_state(tmp_path):
    """Resuming with a different seed/scene/config must NOT blend streams:
    the stamped fingerprint mismatch restarts the render from scratch."""
    import pytest

    scene, cam = scene_and_cam()
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=4, max_depth=3,
                       samples_per_pass=2, seed=3)
    ckpt = preview_lib.RenderCheckpoint(str(tmp_path / "fp.ckpt"))
    img_a, stats_a = preview_lib.render_progressive(scene, cam, cfg, None, ckpt)
    assert stats_a["resumed_at_chunk"] == 0

    # Same checkpoint, different seed -> must warn and start fresh, and the
    # result must equal a cold render at the new seed.
    cfg2 = cfg.replace(seed=99)
    with pytest.warns(RuntimeWarning, match="fingerprint mismatch"):
        img_b, stats_b = preview_lib.render_progressive(scene, cam, cfg2, None, ckpt)
    assert stats_b["resumed_at_chunk"] == 0
    cold, _ = preview_lib.render_progressive(scene, cam, cfg2, None, None)
    np.testing.assert_array_equal(img_b, cold)

    # Matching config resumes as before (fingerprint round-trips).
    img_c, stats_c = preview_lib.render_progressive(scene, cam, cfg2, None, ckpt)
    assert stats_c["resumed_at_chunk"] == 2
    np.testing.assert_array_equal(img_c, cold)
