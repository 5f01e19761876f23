"""Adaptive hierarchical subsampling (the reference's default render mode).

Behavioral port of ``engine::_run_adaptive`` (engine.h:96-333): the image is
tiled into 12x12 "big squares"; the 4 corner pixels of each square are path
traced at full spp into a gamma-corrected int work frame; if all 6.. pairwise
edge distances (sum of squared RGB deltas) are <= 100 the interior is
bilinearly interpolated *in gamma-int space* (the reference's documented
darkening bias, engine.h:139-149); otherwise the square recurses to 6x6 then
3x3, and at 3x3 the 5 non-corner pixels are traced exactly.

Device structure: the scalar tree walk becomes a level-by-level masked
wavefront —
  level 0: trace all big-square corners (fixed pixel set, one device batch);
  level k: the host reads back the tiny per-square heuristic bits, gathers
           the next level's pixel ids, pads them to a power-of-two bucket,
           and launches one fixed-shape device batch (so XLA compiles a
           handful of bucket sizes, not per-frame shapes);
  fill:    interpolation runs on host in int space — O(W*H) cold arithmetic.
Ray tracing (the 99.9% of the work) stays on device with static shapes; the
irregular control flow stays on host.  Divisibility contract preserved:
raises unless 12 | W and 12 | H (engine.h:181-183).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from another_raytracer.config import RenderConfig
from another_raytracer.ops import camera as camera_lib  # noqa: F401 (API surface)
from another_raytracer.ops import render as render_lib

SUBDIVIDE_THRESH = 100  # engine.h:98


def _min_bucket() -> int:
    """Pixel-batch bucket granule: buckets round UP to a multiple of it.
    On an accelerator each distinct bucket size is a separate compile (the
    persistent compile cache, utils/compcache.py, makes the shapes
    one-time), so the granule is coarse; on CPU keep buckets small for fast
    tests.  The device granule was tuned earlier on another accelerator and
    is not yet tuned on the GPU."""
    return 1024 if jax.default_backend() == "cpu" else 8192


def _pack(acc, segs):
    """ONE output array -> ONE host fetch per level (each device->host
    readback pays a fixed round-trip latency regardless of size).  The
    segment count rides as two exact f32 halves: a bitcast int would be a
    denormal float, which flush-to-zero fusions turn into 0."""
    segs = segs.astype(jnp.uint32)
    halves = jnp.stack([(segs >> 16).astype(jnp.float32),
                        (segs & 0xFFFF).astype(jnp.float32)])
    return jnp.concatenate([acc.x, acc.y, acc.z, halves])


def _unpack_segments(tail) -> int:
    return int(tail[0]) * 65536 + int(tail[1])


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "samples_per_pass", "max_depth", "t_min"),
)
def _trace_pixels(scene, cam, pixel_ids, lane_mask, seed, *, width, height,
                  spp, samples_per_pass, max_depth, t_min):
    acc, segs = render_lib.radiance_batch(
        scene, cam, pixel_ids, seed, width=width, height=height,
        sample_start=0, n_samples=spp, spp_cap=spp,
        samples_per_pass=samples_per_pass, max_depth=max_depth, t_min=t_min,
        lane_mask=lane_mask,
    )
    return _pack(acc, segs)


@partial(
    jax.jit,
    static_argnames=("mesh", "width", "height", "spp", "samples_per_pass",
                     "max_depth", "t_min"),
)
def _trace_pixels_sharded(scene, cam, pixel_ids, lane_mask, seed, *, mesh,
                          width, height, spp, samples_per_pass, max_depth,
                          t_min):
    """Adaptive pixel batches over the device mesh: pixels shard over 'tile',
    the sample range over 'spp' with a psum — the same decomposition as
    parallel_stripes/images (parallel/sharding.py), applied to the bucketed
    batches.  The reference runs its adaptive mode over 4 pool threads
    (engine.h:298-317); this is the device-mesh analogue.  Bucket sizes are
    powers of two >= 1024, so they always divide by the mesh axes."""
    from jax.sharding import PartitionSpec as P

    n_spp = mesh.shape["spp"]
    spp_local = -(-spp // n_spp)

    def shard_fn(scene, cam, seed, pix_local, mask_local):
        spp_idx = jax.lax.axis_index("spp")
        acc, segs = render_lib.radiance_batch(
            scene, cam, pix_local, seed, width=width, height=height,
            sample_start=(spp_idx * spp_local).astype(jnp.uint32),
            n_samples=spp_local, spp_cap=spp,
            samples_per_pass=samples_per_pass, max_depth=max_depth,
            t_min=t_min, lane_mask=mask_local,
        )
        acc = jax.lax.psum(acc, "spp")
        segs = jax.lax.psum(segs, ("tile", "spp"))
        return acc, segs

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P("tile"), P("tile")),
        out_specs=(P("tile"), P()),
        check_vma=True,  # see parallel/sharding.py note
    )
    acc, segs = fn(scene, cam, seed, pixel_ids, lane_mask)
    return _pack(acc, segs)


def _bucket(n: int) -> int:
    g = _min_bucket()
    return -(-n // g) * g


def _to_int_color(radiance_sum, spp):
    """write_color<int>: mean, gamma-2, clamp [0,0.999], x256, truncate
    (color.h:13-22)."""
    c = np.sqrt(np.maximum(radiance_sum / spp, 0.0))
    return (256.0 * np.clip(c, 0.0, 0.999)).astype(np.int64)


def _heuristic(work, xs, ys, size, thresh=SUBDIVIDE_THRESH):
    """Corner-difference subdivision test (engine.h:96-137) for squares with
    upper-left pixels (xs, ys) [vectorized]; returns bool array."""
    s = size - 1
    c1 = work[ys, xs].astype(np.int64)  # up-left
    c2 = work[ys, xs + s].astype(np.int64)  # up-right
    c3 = work[ys + s, xs].astype(np.int64)  # bottom-left
    c4 = work[ys + s, xs + s].astype(np.int64)  # bottom-right
    d1 = ((c1 - c2) ** 2).sum(-1)
    d2 = ((c2 - c4) ** 2).sum(-1)
    d3 = ((c4 - c3) ** 2).sum(-1)
    d4 = ((c3 - c1) ** 2).sum(-1)
    return (d1 > thresh) | (d2 > thresh) | (d3 > thresh) | (d4 > thresh)


def _interpolate_squares(work, xs, ys, size):
    """Bilinear fill of each square's un-evaluated pixels from its corner
    colors, in gamma-int space with truncation (engine.h:139-149,186-219)."""
    if len(xs) == 0:
        return
    s = size - 1
    q11 = work[ys, xs].astype(np.float64)  # (x1, y1)
    q12 = work[ys + s, xs].astype(np.float64)  # (x1, y2)
    q21 = work[ys, xs + s].astype(np.float64)  # (x2, y1)
    q22 = work[ys + s, xs + s].astype(np.float64)  # (x2, y2)
    for l in range(size):
        wy = l / s
        for k in range(size):
            if (k, l) in ((0, 0), (s, 0), (0, s), (s, s)):
                continue
            wx = k / s
            r1 = (1 - wx) * q11 + wx * q21
            r2 = (1 - wx) * q12 + wx * q22
            val = ((1 - wy) * r1 + wy * r2).astype(np.int64)
            px = xs + k
            py = ys + l
            not_eval = work[py, px, 0] < 0  # don't overwrite evaluated pixels
            work[py[not_eval], px[not_eval]] = val[not_eval]


def render_adaptive(scene, cam, config: RenderConfig, mesh=None, progress=None):
    """Adaptive render -> (uint8 image [H,W,3], stats).

    stats['traced_pixels'] counts pixels actually path traced (the honest
    workload measure the reference's kRay/s metric overcounts).

    ``mesh``: optional ('tile', 'spp') device mesh; the bucketed pixel
    batches shard across it (bit-identical output — the RNG keys on absolute
    (pixel, sample) ids).  Defaults to all devices on 'tile' when more than
    one is visible, mirroring the reference's always-4-threads adaptive
    (engine.h:313-317).

    ``progress``: optional sink with ``update_image(img_uint8, traced)``
    (utils/preview.ProgressivePreview); called after every level's trace +
    interpolate so live viewers stream the work frame as it fills — the
    analog of the reference's per-square ``dgui.show(work_image)``
    (engine.h:307).  Not-yet-evaluated pixels show black.  The final image
    is unaffected by the callback."""
    if mesh is None and len(jax.devices()) > 1:
        from another_raytracer.parallel import sharding

        mesh = sharding.hybrid_mesh()
    W, H = config.width, config.height
    big = config.adaptive_tile
    if big % 2 != 0 or (big // 2) % 2 != 0:
        raise ValueError("adaptive tile must be divisible by 4 (12 canonical)")
    mid, small = big // 2, big // 4
    if W % big or H % big:
        raise ValueError(
            "for adaptive strategy image size should perfectly fit big square size for now!!"
        )

    spp = config.samples_per_pixel
    work = np.full((H, W, 3), -1, np.int64)
    total_segments = 0
    traced = 0

    def eval_pixels(px, py):
        """Trace (unique, not-yet-evaluated) pixels at full spp into the work
        frame.  The reference re-traces corners shared between levels
        (evaluate_corners is unconditional, engine.h:222-232); with a
        deterministic per-(pixel,sample) RNG a re-trace reproduces the same
        value, so skipping it changes nothing but the work done."""
        nonlocal total_segments, traced
        if len(px) == 0:
            return
        flat = np.unique(py.astype(np.int64) * W + px.astype(np.int64))
        flat = flat[work[flat // W, flat % W, 0] < 0]
        if len(flat) == 0:
            return
        traced += len(flat)
        b = _bucket(len(flat))
        # None means the configured samples_per_pass (see
        # RenderConfig.adaptive_spass).
        spass = config.adaptive_spass
        if spass is None:
            spass = config.samples_per_pass
        # Pad lanes are DEAD (lane_mask False -> born past the sample cap):
        # they trace nothing and count no segments.  Before this, padding
        # replicated flat[0] and re-traced real pixels — ~45% of the
        # reference-default adaptive workload across its 4 bucket launches.
        padded = np.zeros(b, np.uint32)
        padded[: len(flat)] = flat
        mask = np.zeros(b, bool)
        mask[: len(flat)] = True
        kw = dict(width=W, height=H, spp=spp, samples_per_pass=spass,
                  max_depth=config.max_depth, t_min=config.t_min)
        if mesh is not None:
            packed = _trace_pixels_sharded(
                scene, cam, jnp.asarray(padded), jnp.asarray(mask),
                jnp.uint32(config.seed), mesh=mesh, **kw)
        else:
            packed = _trace_pixels(
                scene, cam, jnp.asarray(padded), jnp.asarray(mask),
                jnp.uint32(config.seed), **kw)
        packed = np.asarray(packed)  # the level's single host round trip
        acc = packed[: 3 * b].reshape(3, b)[:, : len(flat)].T
        total_segments += _unpack_segments(packed[3 * b :])
        work[flat // W, flat % W] = _to_int_color(acc, spp)

    _level = [0]

    def show_progress():
        # Console progress line per level (reference: "\r...%" lines,
        # engine.h:320); the filled fraction counts decided pixels.
        import sys as _sys

        _level[0] += 1
        decided = int((work[..., 0] >= 0).sum())
        print(f"\radaptive level {_level[0]}: {decided * 100 // (W * H)}% "
              f"filled, {traced} traced", end="", file=_sys.stderr, flush=True)
        if progress is not None:
            progress.update_image(
                np.clip(work, 0, 255).astype(np.uint8), traced)

    # --- level 0: big-square corners --------------------------------------
    bx, by = np.meshgrid(np.arange(0, W, big), np.arange(0, H, big))
    bx, by = bx.ravel(), by.ravel()
    offs = np.array([0, big - 1])
    cx, cy = np.broadcast_arrays(
        bx[:, None, None] + offs[None, :, None],
        by[:, None, None] + offs[None, None, :],
    )
    eval_pixels(cx.ravel(), cy.ravel())
    thresh = config.adaptive_threshold
    sub_big = _heuristic(work, bx, by, big, thresh)

    # flat big squares -> interpolate now
    _interpolate_squares(work, bx[~sub_big], by[~sub_big], big)
    show_progress()

    # --- level 1: mid-square corners inside subdivided bigs ----------------
    # enumerate the 4 mid squares per subdivided big square
    sx = (bx[sub_big][:, None] + np.array([0, mid, 0, mid])[None, :]).ravel()
    sy = (by[sub_big][:, None] + np.array([0, 0, mid, mid])[None, :]).ravel()
    offs_m = np.array([0, mid - 1])
    cx, cy = np.broadcast_arrays(
        sx[:, None, None] + offs_m[None, :, None],
        sy[:, None, None] + offs_m[None, None, :],
    )
    eval_pixels(cx.ravel(), cy.ravel())
    sub_mid = _heuristic(work, sx, sy, mid, thresh) if len(sx) else np.zeros(0, bool)
    _interpolate_squares(work, sx[~sub_mid], sy[~sub_mid], mid)
    show_progress()

    # --- level 2: small-square corners inside subdivided mids --------------
    tx = (sx[sub_mid][:, None] + np.array([0, small, 0, small])[None, :]).ravel()
    ty = (sy[sub_mid][:, None] + np.array([0, 0, small, small])[None, :]).ravel()
    offs_s = np.array([0, small - 1])
    cx, cy = np.broadcast_arrays(
        tx[:, None, None] + offs_s[None, :, None],
        ty[:, None, None] + offs_s[None, None, :],
    )
    eval_pixels(cx.ravel(), cy.ravel())
    sub_small = _heuristic(work, tx, ty, small, thresh) if len(tx) else np.zeros(0, bool)
    _interpolate_squares(work, tx[~sub_small], ty[~sub_small], small)
    show_progress()

    # --- level 3: exact trace of remaining pixels of subdivided smalls -----
    # For small=3 these are the 5 non-corner pixels (engine.h:265-277); for
    # general small sizes: every not-yet-evaluated pixel in the square.
    ex_list_x, ex_list_y = [], []
    for k in range(small):
        for l in range(small):
            if (k, l) in ((0, 0), (small - 1, 0), (0, small - 1), (small - 1, small - 1)):
                continue
            ex_list_x.append(tx[sub_small] + k)
            ex_list_y.append(ty[sub_small] + l)
    if ex_list_x:
        eval_pixels(np.concatenate(ex_list_x), np.concatenate(ex_list_y))

    assert (work >= 0).all(), "adaptive fill left unevaluated pixels"
    img = work.astype(np.uint8)
    import sys as _sys
    print(f"\radaptive done: 100% filled, {traced}/{W * H} pixels traced",
          file=_sys.stderr, flush=True)
    if progress is not None:
        progress.update_image(img, traced)
    return img, {
        "segments": total_segments,
        "traced_pixels": traced,
        "total_pixels": W * H,
        "mesh": dict(mesh.shape) if mesh is not None else None,
    }
