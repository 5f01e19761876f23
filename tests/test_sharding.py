"""Device-mesh sharding: every layout must reproduce the single-device
render bit-for-bit (counter-based RNG makes contributions placement-
invariant; the sum order over the spp axis is fixed by the psum tree, so
f32 sums match to ulp-level tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from another_raytracer.models import library
from another_raytracer.ops import camera as camera_lib
from another_raytracer.ops.render import render_radiance
from another_raytracer.parallel import sharding

W, H, SPP, DEPTH = 48, 24, 4, 4


@pytest.fixture(scope="module")
def setup():
    scene, cam_params = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cam_params)
    ref, segs = render_radiance(
        scene, cam, jnp.uint32(1), width=W, height=H, spp=SPP,
        samples_per_pass=2, max_depth=DEPTH, t_min=1e-3,
    )
    from another_raytracer.ops import vec3
    return scene, cam, vec3.to_numpy(ref), int(segs)


@pytest.mark.parametrize("n_tile,n_spp", [(8, 1), (1, 4), (4, 2), (2, 2)])
def test_sharded_matches_single_device(setup, n_tile, n_spp):
    scene, cam, ref, ref_segs = setup
    mesh = sharding.hybrid_mesh(n_tile, n_spp)
    acc, segs = sharding.render_radiance_sharded(
        scene, cam, jnp.uint32(1), mesh=mesh, width=W, height=H, spp=SPP,
        samples_per_pass=2, max_depth=DEPTH, t_min=1e-3,
    )
    from another_raytracer.ops import vec3
    np.testing.assert_allclose(vec3.to_numpy(acc), ref, rtol=1e-5, atol=1e-5)
    assert int(segs) == ref_segs


def test_render_modes_dispatch(setup):
    scene, cam, ref, _ = setup
    from another_raytracer.config import RenderConfig, RenderMode
    from another_raytracer.ops import render as render_lib
    from another_raytracer.ops import color as color_lib

    ref_img = np.asarray(color_lib.to_uint8(jnp.asarray(ref), SPP)).reshape(H, W, 3)
    for mode in (RenderMode.PARALLEL_STRIPES, RenderMode.PARALLEL_IMAGES):
        cfg = RenderConfig(width=W, height=H, samples_per_pixel=SPP,
                           max_depth=DEPTH, seed=1, samples_per_pass=2, mode=mode)
        img, stats = render_lib.render(scene, cam, cfg)
        # uint8 quantization can flip on exact ties; allow a tiny budget.
        assert (img.astype(int) - ref_img.astype(int) != 0).mean() < 0.001
