"""Adaptive subsampling: traced pixels match the exact render; interpolated
pixels are plausible; contract errors match the reference."""

import numpy as np
import jax.numpy as jnp
import pytest

from another_raytracer.config import RenderConfig, RenderMode
from another_raytracer.models import library
from another_raytracer.ops import camera as camera_lib
from another_raytracer.ops import color as color_lib
from another_raytracer.ops import render as render_lib

W, H, SPP, DEPTH = 48, 36, 4, 4


def test_adaptive_matches_exact_on_traced_pixels():
    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP, max_depth=DEPTH,
                       seed=1, samples_per_pass=2, mode=RenderMode.ADAPTIVE)
    img, stats = render_lib.render(scene, cam, cfg)
    assert img.shape == (H, W, 3)
    assert 0 < stats["traced_pixels"] <= W * H

    exact, _ = render_lib.render_radiance(
        scene, cam, jnp.uint32(1), width=W, height=H, spp=SPP,
        samples_per_pass=2, max_depth=DEPTH, t_min=1e-3,
    )
    from another_raytracer.ops import vec3
    exact_img = np.asarray(color_lib.to_uint8(vec3.to_numpy(exact), SPP)).reshape(H, W, 3)

    # Big-square corner pixels are always traced exactly: identical values.
    corner_mask = np.zeros((H, W), bool)
    for yy in range(0, H, 12):
        for xx in range(0, W, 12):
            for dy in (0, 11):
                for dx in (0, 11):
                    corner_mask[yy + dy, xx + dx] = True
    assert np.array_equal(img[corner_mask], exact_img[corner_mask])

    # Whole image should be close to exact (interpolation only fills flats).
    diff = np.abs(img.astype(int) - exact_img.astype(int))
    assert np.median(diff) <= 3
    # The adaptive pass must actually skip work on this scene (flat walls).
    assert stats["traced_pixels"] < 0.95 * W * H


def test_adaptive_divisibility_contract():
    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=1.0, **cam_params)
    cfg = RenderConfig(width=50, height=36, samples_per_pixel=2, max_depth=2,
                       mode=RenderMode.ADAPTIVE)
    with pytest.raises(ValueError, match="perfectly fit"):
        render_lib.render(scene, cam, cfg)


def test_adaptive_threshold_knob_is_live():
    """config.adaptive_threshold must drive subdivision (round-1 VERDICT: the
    knob was dead — ops/adaptive.py hardcoded 100)."""
    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    base = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=3,
                        seed=1, samples_per_pass=2, mode=RenderMode.ADAPTIVE)

    # Threshold so large nothing subdivides: only the 4 corners of each of
    # the (W/12)*(H/12) big squares are traced.
    _, hi = render_lib.render(scene, cam, base.replace(adaptive_threshold=1e18))
    assert hi["traced_pixels"] == (W // 12) * (H // 12) * 4

    # Threshold below zero: every square subdivides all the way down and
    # every pixel is traced exactly.
    _, lo = render_lib.render(scene, cam, base.replace(adaptive_threshold=-1.0))
    assert lo["traced_pixels"] == W * H


def test_adaptive_sharded_matches_single_device():
    """Adaptive over the 8-device mesh must be bit-identical to the
    single-device adaptive render (round-1 VERDICT #7: the reference's
    default mode runs over 4 threads; ours must scale over chips)."""
    import jax

    from another_raytracer.ops import adaptive as adaptive_lib
    from another_raytracer.parallel import sharding

    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP, max_depth=DEPTH,
                       seed=1, samples_per_pass=2, mode=RenderMode.ADAPTIVE)

    # Force single-device by passing a 1x1 mesh.
    mesh1 = sharding.hybrid_mesh(1, 1, devices=jax.devices()[:1])
    img_single, s_single = adaptive_lib.render_adaptive(scene, cam, cfg, mesh=mesh1)
    assert s_single["mesh"] == {"tile": 1, "spp": 1}

    mesh8 = sharding.hybrid_mesh(4, 2)
    img_mesh, s_mesh = adaptive_lib.render_adaptive(scene, cam, cfg, mesh=mesh8)
    assert s_mesh["mesh"] == {"tile": 4, "spp": 2}
    np.testing.assert_array_equal(img_mesh, img_single)
    assert s_mesh["traced_pixels"] == s_single["traced_pixels"]
    assert s_mesh["segments"] == s_single["segments"] > 0

    # The default dispatch (render() with >1 device) also shards.
    img_def, s_def = render_lib.render(scene, cam, cfg)
    assert s_def["mesh"] is not None
    np.testing.assert_array_equal(img_def, img_single)


def test_adaptive_streams_progress_and_image_unchanged():
    """--mode adaptive --live/--preview: the work frame streams per level
    (reference: per-square dgui.show, engine.h:307) and the final image is
    bit-identical to a plain adaptive render (round-2 VERDICT #5)."""
    from another_raytracer.utils.preview import ProgressivePreview

    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP, max_depth=DEPTH,
                       seed=1, samples_per_pass=2, mode=RenderMode.ADAPTIVE)

    class Sink:
        frames = []

        def update(self, img, n):
            self.frames.append((np.array(img), n))

    sink = Sink()
    prev = ProgressivePreview(path=None, width=W, height=H, viewer=sink)
    img_prog, _ = render_lib.render(scene, cam, cfg, progress=prev)
    img_plain, _ = render_lib.render(scene, cam, cfg)

    np.testing.assert_array_equal(img_prog, img_plain)
    assert len(sink.frames) >= 2  # at least one level + the final frame
    for frame, _ in sink.frames:
        assert frame.shape == (H, W, 3) and frame.dtype == np.uint8
    # the stream ends on the finished image
    np.testing.assert_array_equal(sink.frames[-1][0], img_plain)
    # earlier snapshots are partial (some pixels still black/unevaluated)
    assert (sink.frames[0][0] != img_plain).any()


def test_sharded_modes_reject_progress():
    from another_raytracer.utils.preview import ProgressivePreview

    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP, max_depth=DEPTH,
                       mode=RenderMode.PARALLEL_IMAGES)
    prev = ProgressivePreview(path=None, width=W, height=H, viewer=object())
    with pytest.raises(ValueError, match="cannot stream progress"):
        render_lib.render(scene, cam, cfg, progress=prev)


@pytest.mark.parametrize("segs", [0, 1, 65535, 65536, 97_200 * 1000,
                                  2**31 - 1])
def test_segment_packing_is_exact(segs):
    # The one-fetch packing carries the segment count as two f32 halves;
    # a count bitcast into one f32 would be a denormal that flush-to-zero
    # fusions zero out (seen on the sharded path).
    from another_raytracer.ops import adaptive as adaptive_lib
    from another_raytracer.ops.vec3 import V3

    z = jnp.zeros((4,), jnp.float32)
    packed = np.asarray(adaptive_lib._pack(V3(z, z + 1, z + 2),
                                           jnp.int32(segs)))
    assert packed.shape == (14,)
    assert adaptive_lib._unpack_segments(packed[12:]) == segs
