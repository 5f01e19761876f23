"""Regenerating forward wavefront (integrator.trace_regenerative) must be
bit-identical to the lockstep chunk-scan path: same RNG draws per (pixel,
sample, bounce), same per-sample fp add grouping."""

import numpy as np
import jax.numpy as jnp
import pytest

from another_raytracer.models import library
from another_raytracer.ops import camera as camera_lib
from another_raytracer.ops import integrator
from another_raytracer.ops import render as render_lib
from another_raytracer.ops import vec3

W, H = 48, 36


def _render(scene, cam, regen, spp=6, spass=1, depth=5, seed=0):
    import jax

    old = integrator.REGEN_FORWARD
    integrator.REGEN_FORWARD = regen
    # REGEN_FORWARD (and the other integrator knobs) are trace-time flags;
    # render_radiance's jit cache keys only on (statics, avals), so without
    # this the second variant would silently reuse the first's program and
    # the comparison would be vacuous.
    render_lib.clear_trace_caches()
    try:
        f = jax.jit(lambda s, c, _k=(regen, spass): render_lib.render_radiance(
            s, c, jnp.uint32(seed), width=W, height=H, spp=spp,
            samples_per_pass=spass, max_depth=depth, t_min=1e-3))
        acc, segs = f(scene, cam)
        return vec3.to_numpy(acc), int(segs)
    finally:
        integrator.REGEN_FORWARD = old
        render_lib.clear_trace_caches()


@pytest.mark.parametrize("builder", [library.cornell_box, library.cornell_smoke,
                                     library.random_scene])
def test_regen_bit_equal_spass1(builder):
    scene, cp = builder()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cp)
    a, sa = _render(scene, cam, regen=False)
    b, sb = _render(scene, cam, regen=True)
    np.testing.assert_array_equal(a, b)
    assert sa == sb


@pytest.mark.parametrize("builder", [library.cornell_box, library.random_scene])
def test_regen_staged_compaction_bit_equal(builder, monkeypatch):
    """Staged tail compaction (survivor gather into narrower buffers) must be
    bit-identical to the single-stage wavefront AND the lockstep path: the
    per-lane running totals are carried through each compaction, so every
    pixel's accumulation chain is unchanged.  Test batches are far below the
    production MIN_B, so force tiny stage widths to exercise 3 stages
    (48*36=1728 -> 256 -> 128 ... aligned) including ragged sample ends."""
    monkeypatch.setattr(integrator, "REGEN_COMPACT_MIN_B", 64)
    monkeypatch.setattr(integrator, "REGEN_COMPACT_ALIGN", 128)
    scene, cp = builder()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cp)
    b, sb = _render(scene, cam, regen=True, spp=5, spass=2)
    monkeypatch.setattr(integrator, "REGEN_COMPACT", False)
    a, sa = _render(scene, cam, regen=True, spp=5, spass=2)
    np.testing.assert_array_equal(a, b)
    assert sa == sb
    # and against the lockstep scan at spass=1 (the bit-equality contract)
    monkeypatch.setattr(integrator, "REGEN_COMPACT", True)
    c, sc = _render(scene, cam, regen=True, spp=6, spass=1)
    monkeypatch.setattr(integrator, "REGEN_COMPACT", False)
    d, sd = _render(scene, cam, regen=False, spp=6, spass=1)
    np.testing.assert_array_equal(c, d)
    assert sc == sd


def test_regen_spass_gt1_allclose():
    """spass>1 regroups the per-pixel sample additions (lane-major vs
    chunk-major) — fp-level differences only."""
    scene, cp = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cp)
    a, sa = _render(scene, cam, regen=False, spp=6, spass=2)
    b, sb = _render(scene, cam, regen=True, spp=6, spass=2)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert sa == sb


def test_regen_respects_spp_cap_and_ragged_chunks():
    """Ragged sample ranges (spp not divisible by spass, spp_cap) must not
    leak extra samples into the accumulator."""
    scene, cp = library.cornell_box()
    cam = camera_lib.make_camera(aspect_ratio=W / H, **cp)
    a, _ = _render(scene, cam, regen=False, spp=5, spass=2)
    b, _ = _render(scene, cam, regen=True, spp=5, spass=2)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
