"""All nine canonical scenes build and render finite images (device-only
smoke; oracle parity for the tractable ones lives in test_vs_oracle)."""

import numpy as np
import pytest

from another_raytracer.config import RenderConfig, RenderMode
from another_raytracer.models import library
from another_raytracer.ops import camera as camera_lib
from another_raytracer.ops import render as render_lib
from another_raytracer.utils import assets


@pytest.mark.parametrize("alias", list(library.SceneAlias))
def test_scene_renders(alias, ref_assets):
    scene, cam_params = library.build(alias)
    cfg = RenderConfig(width=48, height=36, samples_per_pixel=2, max_depth=4,
                       samples_per_pass=2, mode=RenderMode.SINGLE)
    cam = camera_lib.make_camera(aspect_ratio=cfg.aspect_ratio, **cam_params)
    img, stats = render_lib.render(scene, cam, cfg)
    assert img.shape == (36, 48, 3) and img.dtype == np.uint8
    assert stats["segments"] > 0
    # Every scene should produce some non-black pixels at these settings.
    assert img.max() > 0


def test_scene_counts():
    """Structural expectations per scene_manager.cpp."""
    scene, _ = library.cornell_box()
    # 6 walls/light + 2 boxes x 6 rects
    assert scene.n_rects == 6 + 12
    assert scene.n_media == 0

    scene, _ = library.cornell_smoke()
    assert scene.n_rects == 6
    assert scene.n_media == 2

    scene, _ = library.two_spheres()
    assert scene.n_spheres == 2

    scene, _ = library.final_scene()
    # 400 ground boxes x 6 rects + 1 light rect
    assert scene.n_rects == 2400 + 1
    # 1 moving + glass + metal + boundary + earth + perlin + 1000 cluster
    assert scene.n_spheres == 1006
    assert scene.n_media == 2


def test_random_scene_deterministic_per_seed():
    s1, _ = library.random_scene(seed=7)
    s2, _ = library.random_scene(seed=7)
    s3, _ = library.random_scene(seed=8)
    np.testing.assert_array_equal(np.asarray(s1.sph_c0), np.asarray(s2.sph_c0))
    assert s1.n_spheres != s3.n_spheres or not np.array_equal(
        np.asarray(s1.sph_c0), np.asarray(s3.sph_c0)
    )


def test_unknown_scene_raises():
    with pytest.raises(ValueError, match="unknown scene"):
        library.build(42)


def test_empty_scene_raises():
    from another_raytracer.models.scene import SceneBuilder
    scene = SceneBuilder().build()
    cfg = RenderConfig(width=12, height=12, samples_per_pixel=1, max_depth=1)
    cam = camera_lib.make_camera(lookfrom=(0, 0, 1), lookat=(0, 0, 0), vfov=60,
                                 aspect_ratio=1.0)
    with pytest.raises(ValueError, match="empty scene"):
        render_lib.render(scene, cam, cfg)


def test_medium_record_threads_t_min():
    """The medium winner recompute must clamp the boundary entry to the
    *configured* t_min, matching the selection sweep (round-1 VERDICT: it
    hardcoded 1e-3, so non-default t_min renders disagreed with selection)."""
    import jax.numpy as jnp
    import numpy as np

    from another_raytracer.models.scene import SceneBuilder
    from another_raytracer.ops import intersect
    from another_raytracer.ops.vec3 import V3

    b = SceneBuilder()
    b.constant_medium_box((0, 0, 0), (1, 1, 1), density=10.0, color=(1, 1, 1))
    scene = b.build()

    # Ray starting inside the box: entry t1 < 0, so the recompute's entry
    # clamp IS the configured t_min.
    B = 4
    o = V3(jnp.full((B,), 0.5), jnp.full((B,), 0.5), jnp.full((B,), 0.5))
    d = V3(jnp.ones((B,)), jnp.zeros((B,)), jnp.zeros((B,)))
    time = jnp.zeros((B,))
    u_media = jnp.full((B, 1), 0.7)
    t_min = 0.25

    t, kind, idx = intersect.closest_hit(scene, o, d, time, u_media, t_min)
    assert bool((kind == 3).all()), "expected the medium to win"
    rec = intersect.make_hit_record(scene, o, d, time, t, kind, idx,
                                    u_media=u_media, t_min=t_min)
    np.testing.assert_allclose(np.asarray(rec.t), np.asarray(t), rtol=1e-6)
    # Sanity: the hit is beyond the configured epsilon, not the old 1e-3.
    assert float(rec.t.min()) >= t_min
