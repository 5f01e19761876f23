"""Top-level render driver: pixels × samples -> radiance sums -> pixels.

Replaces ``engine<W,H,C>::run`` and its per-mode loops (engine.h:30-54).  One
jitted pass traces all pixels at ``samples_per_pass`` samples; a ``lax.scan``
over passes accumulates the per-pixel radiance sum; ``ops.color`` applies the
spp-average + gamma-2 + clamp of the reference's write_color (color.h:13-22).

Device-parallel modes (stripes = pixel sharding, images = spp sharding +
psum) live in ``parallel/sharding.py``; adaptive subsampling in
``ops/adaptive.py``.  This module is the single-device "single" mode that all
of those reuse.
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from another_raytracer.config import RenderConfig, RenderMode
from another_raytracer.ops import camera as camera_lib
from another_raytracer.ops import color as color_lib
from another_raytracer.ops import integrator


def radiance_batch(scene, cam, pixel_ids, seed, *, width, height,
                   sample_start, n_samples, spp_cap, samples_per_pass,
                   max_depth, t_min, differentiable=False, remat=False,
                   unroll=None, chunk_unroll=1, trainable=None,
                   lane_mask=None):
    """Radiance sums for an arbitrary pixel batch over samples
    [sample_start, sample_start + n_samples) ∩ [0, spp_cap).

    The building block for every render mode: single calls it with all
    pixels; stripes shard the pixel axis; parallel_images shards the sample
    range (then psums).  Because the RNG is keyed on absolute (pixel, sample)
    ids, any partition produces identical contributions.

    ``trainable`` (differentiable renders only): the caller's trainable
    scene-leaf names, e.g. ``tuple(params)`` from grad/diff.py.  The fused
    differentiable path (ops/pallas/mega_diff.py) auto-engages only when
    this set is declared and free of geometry leaves — it returns hard-zero
    geometry cotangents by construction, so an undeclared (None) set
    conservatively keeps the exact XLA autodiff path.

    ``lane_mask`` ([Np] bool, optional): lanes where False are PAD lanes —
    born dead (their samples start past the cap), contributing zero
    radiance and zero segments.  The adaptive mode's bucketed batches use
    this so padding traces nothing.

    Returns (radiance_sum V3 of [Np], segments [] int32).
    """
    from another_raytracer.ops import vec3
    from another_raytracer.ops.vec3 import V3

    n_pixels = pixel_ids.shape[0]
    spass = min(samples_per_pass, n_samples)
    n_chunks = -(-n_samples // spass)

    # Sample-major ray layout: rays[s*Np + p] belongs to pixel p, sample s.
    pix = jnp.tile(pixel_ids, spass)
    samp_offsets = jnp.repeat(jnp.arange(spass, dtype=jnp.uint32), n_pixels)
    lanes_ok = None if lane_mask is None else jnp.tile(lane_mask, spass)

    if not differentiable and integrator.REGEN_FORWARD and n_samples > spass:
        # Forward renders use the regenerating wavefront: lanes re-arm with
        # their next sample on path termination instead of idling in
        # lockstep, replacing the chunk scan + fixed bounce loop (see
        # integrator.trace_regenerative).  Bit-identical at spass=1 (the
        # default); spass>1 regroups per-pixel sample additions (fp-level
        # only).  The gradient path keeps the scan (fixed trip count).
        from another_raytracer.ops.pallas import mega_kernel

        if mega_kernel.enabled(scene, cam):
            # Sweep-regime scenes on the GPU run the ENTIRE wavefront loop
            # inside one Pallas kernel, one ray per thread with its state in
            # registers (ops/pallas/mega_kernel.py).  Tolerance-level FP
            # divergence from the XLA path (GPU transcendentals).
            trace_fn = mega_kernel.trace_regenerative_mega
        else:
            trace_fn = integrator.trace_regenerative
        samp0 = samp_offsets + jnp.uint32(sample_start)
        if lanes_ok is not None:
            # Pad lanes start past every sample limit -> born dead (the
            # staged compaction drops them after the first stage; the mega
            # kernel skips them from iteration 0).
            samp0 = jnp.where(lanes_ok, samp0, jnp.uint32(0xFFFFFFFF))
        acc, segments = trace_fn(
            scene, cam, pix, samp0, seed,
            width=width, height=height, sample_stride=spass,
            sample_end=jnp.uint32(sample_start) + n_samples, spp_cap=spp_cap,
            max_depth=max_depth, t_min=t_min,
        )
        acc = acc.map(lambda c: c.reshape(spass, n_pixels).sum(axis=0))
        return acc, segments

    if (differentiable and lane_mask is None and isinstance(sample_start, int)
            and sample_start == 0 and n_samples == spp_cap):
        from another_raytracer.ops.pallas import mega_diff

        if mega_diff.enabled(scene, cam, spp_cap, spass, max_depth,
                             pix.shape[0], trainable=trainable):
            # Fused differentiable path (lambertian/light + solid sweep
            # scenes): megakernel primal with residual codes + pure-replay
            # backward — no sweep or shading recompute in the bwd.  Exact
            # for the shading-parameter gradients this render exposes; see
            # ops/pallas/mega_diff.py for the gradient-scope contract.
            acc, segments = mega_diff.radiance_fused(
                scene, cam, pix, samp_offsets, seed, width=width,
                height=height, sample_stride=spass, spp_cap=spp_cap,
                max_depth=max_depth, t_min=t_min,
                interpret=mega_diff.INTERPRET)
            acc = acc.map(lambda c: c.reshape(spass, n_pixels).sum(axis=0))
            return acc, segments

    def one_pass(carry, chunk):
        acc, segments = carry
        sample_ids = samp_offsets + sample_start + chunk * spass
        o, d, time = camera_lib.generate_rays(
            cam, pix, sample_ids, width, height, seed,
            needs_time=scene.has_motion,
        )
        # Samples beyond the range (ragged last chunk / spp cap) and pad
        # lanes start dead: no segments, zero radiance.
        valid = (sample_ids < jnp.uint32(sample_start) + n_samples) & (sample_ids < spp_cap)
        if lanes_ok is not None:
            valid = valid & lanes_ok
        radiance, segs = integrator.trace(
            scene, o, d, time, pix, sample_ids, seed, max_depth, t_min,
            differentiable=differentiable, remat=remat, unroll=unroll,
            alive0=valid,
        )
        radiance = vec3.where(valid, radiance, V3.zeros(valid.shape))
        acc = acc + radiance.map(lambda c: c.reshape(spass, n_pixels).sum(axis=0))
        return (acc, segments + segs), None

    # Zeros derived from pixel_ids AND sample_start inherit the full
    # device-varying type under shard_map — pixels vary over 'tile',
    # sample_start (an axis_index) over 'spp' — so the scan carry types
    # check out (see integrator.trace).  Folds away in compilation.
    zp = ((pixel_ids + jnp.uint32(sample_start)) * 0).astype(jnp.float32)
    init = (V3(zp, zp, zp), zp[0].astype(jnp.int32))
    if n_chunks == 1:
        (acc, segments), _ = one_pass(init, jnp.uint32(0))
    else:
        (acc, segments), _ = jax.lax.scan(
            init=init, xs=jnp.arange(n_chunks, dtype=jnp.uint32),
            f=one_pass, unroll=chunk_unroll,
        )
    return acc, segments


def clear_trace_caches():
    """Drop every jitted entry point's trace cache.

    Module-level switches (integrator.REGEN_COMPACT, mega_diff.FUSED_DIFF,
    ...) are read at TRACE time, but the jitted entry points cache traces
    keyed only on (statics, avals) — toggling a switch and re-calling with
    the same shapes silently reuses the old program.  Every flag-toggling
    test or comparison MUST call this between variants.
    """
    from another_raytracer.grad import diff
    from another_raytracer.ops import adaptive
    from another_raytracer.parallel import sharding

    for fn in (render_radiance, diff.render_value_and_grad,
               adaptive._trace_pixels, adaptive._trace_pixels_sharded,
               sharding.render_radiance_sharded):
        fn.clear_cache()


@functools.lru_cache(maxsize=32)
def morton_order(width: int, height: int):
    """Z-order (Morton) pixel traversal for a WxH image.

    Returns (order, inverse) uint32 arrays: ``order[k]`` is the flat pixel id
    of the k-th ray.  Scanline order makes a ray batch a long thin strip;
    Morton order makes it a compact square tile, so neighbouring lanes walk
    similar BVH paths and sharded tiles get spatial locality.  Radiance is
    unaffected: the RNG keys on absolute pixel ids.
    """
    def part1by1(v):
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    gx, gy = np.meshgrid(np.arange(width, dtype=np.uint32),
                         np.arange(height, dtype=np.uint32))
    code = part1by1(gx) | (part1by1(gy) << np.uint32(1))
    order = np.argsort(code.ravel(), kind="stable").astype(np.uint32)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0], dtype=np.uint32)
    return order, inv


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "samples_per_pass", "max_depth",
                     "t_min", "differentiable", "trainable"),
)
def render_radiance(scene, cam, seed, *, width, height, spp, samples_per_pass,
                    max_depth, t_min, differentiable=False, trainable=None):
    """Per-pixel radiance sums over ``spp`` samples.

    Returns (radiance_sum V3 of [H*W] in flat pixel order, segments int32).
    The sum is un-averaged, exactly like ``_stochastic_sample`` returning the
    raw sample sum (engine.h:58-68) with averaging deferred to write_color.

    Rays are traced in Morton order only when the scene has a BVH (see
    morton_order).  For sweep-only scenes Morton buys nothing and the
    inverse-permutation gather back to scanline order is pure cost, so it is
    skipped; radiance is identical either way (RNG keys on absolute pixel
    ids).
    """
    if scene.has_accel:
        order, inv = morton_order(width, height)
        pixel_ids = jnp.asarray(order)
    else:
        pixel_ids = jnp.arange(width * height, dtype=jnp.uint32)
    acc, segments = radiance_batch(
        scene, cam, pixel_ids, seed, width=width, height=height,
        sample_start=0, n_samples=spp, spp_cap=spp,
        samples_per_pass=samples_per_pass, max_depth=max_depth, t_min=t_min,
        differentiable=differentiable, trainable=trainable,
    )
    if scene.has_accel:
        inv_j = jnp.asarray(inv)
        acc = acc.map(lambda c: c[inv_j])
    return acc, segments


def render(scene, cam, config: RenderConfig, progress=None):
    """Render to a uint8 image [H, W, 3].

    Returns (image uint8 [H,W,3], stats dict with 'segments' — the honest
    bounce-ray count, unlike the reference's nominal primary-only kRay/s
    metric at main.cpp:50-53).

    ``progress``: optional live-progress sink (utils/preview.
    ProgressivePreview).  Adaptive mode streams its work frame per level;
    for progressive per-pass snapshots in single mode use
    utils/preview.render_progressive (which also checkpoints).  The sharded
    modes render in one device call and don't stream.
    """
    # Empty-scene guard (reference: engine.h:32-36 prints an error and
    # returns -1; here it raises).
    if scene.num_primitives == 0:
        raise ValueError("cannot render empty scene!")
    if config.mode in (RenderMode.PARALLEL_STRIPES, RenderMode.PARALLEL_IMAGES):
        if progress is not None:
            raise ValueError(
                f"mode {config.mode.value} renders in one device call and "
                "cannot stream progress; use --mode single or adaptive with "
                "--live/--preview")
        from another_raytracer.parallel import sharding
        return sharding.render_sharded(scene, cam, config)
    if config.mode == RenderMode.ADAPTIVE:
        from another_raytracer.ops import adaptive
        return adaptive.render_adaptive(scene, cam, config, progress=progress)

    acc, segments = render_radiance(
        scene, cam, jnp.uint32(config.seed),
        width=config.width, height=config.height, spp=config.samples_per_pixel,
        samples_per_pass=config.samples_per_pass, max_depth=config.max_depth,
        t_min=config.t_min,
    )
    from another_raytracer.ops import vec3
    img = np.asarray(color_lib.to_uint8(vec3.to_numpy(acc), config.samples_per_pixel))
    img = img.reshape(config.height, config.width, 3)
    if progress is not None:  # single mode: one final frame
        progress.update_image(img, config.samples_per_pixel)
    return img, {"segments": int(segments)}
