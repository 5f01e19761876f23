"""Thin-lens perspective camera with defocus blur and a motion-blur shutter.

Behavioral contract from the reference ``camera`` (src/engine/camera.h:8-47):
orthonormal basis from lookfrom/lookat/vup, viewport from vfov + aspect,
focal plane at ``focus_dist``, ``lens_radius = aperture/2``, per-ray lens-disk
origin jitter and a uniform random time in the shutter window [time0, time1].

Here the camera is a small pytree of precomputed vectors and ``generate_rays``
produces a whole batch of primary rays at once from pixel/sample id arrays,
with all randomness drawn from the counter-based RNG (ops/rng.py).
Pixel addressing matches the reference sampler (src/engine/engine.h:58-68):
``u = (i + xi) / (W-1)``, ``v = ((H-1-j) + xi) / (H-1)`` — row j=0 is the top
of the image.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from another_raytracer.ops import rng, vec3, vecmath
from another_raytracer.ops.vec3 import V3
from another_raytracer.utils import struct


@struct.dataclass
class Camera:
    origin: jnp.ndarray  # [3]
    lower_left: jnp.ndarray  # [3]
    horizontal: jnp.ndarray  # [3]
    vertical: jnp.ndarray  # [3]
    u: jnp.ndarray  # [3] camera-right basis vector
    v: jnp.ndarray  # [3] camera-up basis vector
    lens_radius: jnp.ndarray  # [] scalar
    time0: jnp.ndarray  # [] shutter open
    time1: jnp.ndarray  # [] shutter close
    # Static metadata (not traced): lets generate_rays skip the lens-disk /
    # shutter-time threefry blocks entirely for pinhole cameras and
    # zero-length shutters.  Draws are keyed per-purpose lanes, so skipping
    # one never shifts another — gated renders are bit-identical.
    has_lens: bool = struct.static_field(True)
    has_time: bool = struct.static_field(True)


def make_camera(
    lookfrom,
    lookat,
    vup=(0.0, 1.0, 0.0),
    vfov=40.0,
    aspect_ratio=4.0 / 3.0,
    aperture=0.0,
    focus_dist=10.0,
    time0=0.0,
    time1=0.0,
    dtype=jnp.float32,
) -> Camera:
    """Construct the camera basis (reference ctor camera.h:8-36).

    Defaults mirror the app wiring: vup=(0,1,0), focus_dist=10, shutter [0,1]
    are fixed at src/main.cpp:33-35; vfov/aperture are per-scene
    (src/scene_manager.cpp:260-355).
    """
    lookfrom = jnp.asarray(lookfrom, dtype)
    lookat = jnp.asarray(lookat, dtype)
    vup = jnp.asarray(vup, dtype)

    theta = math.radians(float(vfov))
    h = math.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = float(aspect_ratio) * viewport_height

    w = vecmath.unit(lookfrom - lookat)
    u = vecmath.unit(jnp.cross(vup, w))
    v = jnp.cross(w, u)

    horizontal = focus_dist * viewport_width * u
    vertical = focus_dist * viewport_height * v
    lower_left = lookfrom - horizontal / 2 - vertical / 2 - focus_dist * w

    return Camera(
        origin=lookfrom,
        lower_left=lower_left,
        horizontal=horizontal,
        vertical=vertical,
        u=u,
        v=v,
        lens_radius=jnp.asarray(aperture / 2.0, dtype),
        time0=jnp.asarray(time0, dtype),
        time1=jnp.asarray(time1, dtype),
        has_lens=float(aperture) != 0.0,
        has_time=float(time1) != float(time0),
    )


def generate_rays(cam: Camera, pixel_ids, sample_ids, width: int, height: int, seed,
                  needs_time: "bool | None" = None):
    """Batched primary-ray generation.

    Args:
      cam: Camera pytree.
      pixel_ids: uint32 [B] flat pixel index ``j * width + i``.
      sample_ids: uint32 [B] sample index within the pixel.
      width, height: static image dims.
      seed: RNG seed (python int or uint32 scalar).

    Returns:
      (origins V3[B], directions V3[B], times [B]) — column SoA (vec3.py).

    Matches ``engine::_stochastic_sample`` pixel->uv mapping (engine.h:58-68)
    and ``camera::get_ray`` (camera.h:38-47).
    """
    pixel_ids = jnp.asarray(pixel_ids, jnp.uint32)
    sample_ids = jnp.asarray(sample_ids, jnp.uint32)

    i = (pixel_ids % jnp.uint32(width)).astype(jnp.float32)
    j = (pixel_ids // jnp.uint32(width)).astype(jnp.float32)

    ju, jv = rng.uniform2(seed, pixel_ids, sample_ids, rng.CAMERA_BOUNCE, rng.DIM_PIXEL_JITTER)

    s = (i + ju) / jnp.float32(width - 1)
    t = (jnp.float32(height - 1) - j + jv) / jnp.float32(height - 1)

    cam_origin = V3.from_array(cam.origin)
    base = V3.from_array(cam.lower_left - cam.origin)
    hor = V3.from_array(cam.horizontal)
    ver = V3.from_array(cam.vertical)

    if cam.has_lens:
        # Defocus: lens-disk origin jitter (camera.h:38-43).
        lu, lv = rng.uniform2(seed, pixel_ids, sample_ids, rng.CAMERA_BOUNCE, rng.DIM_LENS)
        rdx, rdy = vec3.in_unit_disk_from_uniforms(lu, lv)
        rdx = cam.lens_radius * rdx
        rdy = cam.lens_radius * rdy
        cu = V3.from_array(cam.u)  # scalar components
        cv = V3.from_array(cam.v)
        offset = cu * rdx + cv * rdy
        origin = offset + cam_origin
        direction = base + hor * s + ver * t - offset
    else:
        # Pinhole: offset == 0 exactly; broadcast the shared origin to [B].
        origin = cam_origin + V3.zeros(s.shape, s.dtype)
        direction = base + hor * s + ver * t

    if needs_time is None:
        needs_time = cam.has_time
    if cam.has_time and needs_time:
        tu, _ = rng.uniform2(seed, pixel_ids, sample_ids, rng.CAMERA_BOUNCE, rng.DIM_TIME)
        time = cam.time0 + tu * (cam.time1 - cam.time0)
    else:
        # Zero-length shutter, or the caller knows nothing in the scene reads
        # ray time (scene.has_motion False): the draw cannot affect radiance.
        time = jnp.broadcast_to(cam.time0, s.shape)
    return origin, direction, time
