"""Iterative wavefront path integrator (column-SoA state).

The reference integrator is the recursive ``_ray_color`` (engine.h:447-466):
  1. depth exhausted -> black;
  2. miss (t in [1e-3, inf)) -> background;
  3. add emitted;
  4. no scatter -> terminate with emitted;
  5. else emitted + attenuation * recurse(depth-1).

Recursion is untraceable under XLA; here the same contract is an iterative loop
carrying (origin, direction, time, throughput, radiance, alive) for a whole
ray batch in lockstep, with termination as masks.  Unrolling the recursion,
a path contributes ``sum_k (prod_{j<k} attenuation_j) * emitted_k`` plus
background weighted by the throughput at the miss bounce — exactly what the
masked accumulation computes.  No russian roulette and no light sampling,
matching the reference (SURVEY §2.2).

Every vector in the carry is a ``V3`` of [B] arrays (see ops/vec3.py).

Two loop flavors:
  * ``lax.while_loop`` with an any-alive early exit for forward rendering
    (most rays die in a few bounces; the reference's max_depth=50 would cost
    50 full passes in a fixed scan);
  * ``lax.scan`` when differentiability is required (while_loop has no
    reverse-mode rule).  The closest-hit winner search runs entirely behind
    ``stop_gradient`` — backward only differentiates the [B]-sized winner
    recompute, so scan residuals stay small.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from another_raytracer.ops import intersect, rng, shade, vec3
from another_raytracer.ops.vec3 import V3

# Trace-time switch: False restores the separate emitted()+scatter() calls
# (two material-table lookups + two texture evaluations per bounce).
FUSE_SHADE = True

# Zero dead lanes' ray directions and park their origins outside the scene
# before the winner search, so they miss everything cheaply.
ZERO_DEAD_DIRS = True

# With the direction zeroed, a dead lane still carries its last hit point as
# origin — a point INSIDE the scene's BVH boxes, and the slab test admits
# any box containing the origin regardless of direction, so dead lanes kept
# walking the tree.  Parking the origin far outside every canonical scene's
# bounds (|coords| <= ~5000; 1e8 still squares safely in f32) makes every
# slab test fail, so a dead lane's traversal ends at the root.  Only the
# stop-gradient winner search sees the parked origin; the differentiable
# hit-record recompute keeps the real (o, d).
DEAD_PARK = 1e8


# Staged tail compaction for the regenerating wavefront (trace_regenerative):
# when the alive count drops below half the next stage's width, survivors are
# gathered into an ~8x narrower buffer and the loop continues there.  Stages
# stop below MIN_B, where a narrower body no longer beats the compaction
# cost.  The constants were tuned earlier on another accelerator and are not
# yet tuned on the GPU.
REGEN_COMPACT = True
REGEN_COMPACT_MIN_B = 8192
REGEN_COMPACT_SHRINK = 8
REGEN_COMPACT_ALIGN = 1024


def _park_dead(scene, alive, o: V3, d: V3):
    # Parking only pays where a BVH is traversed; on sweep-only scenes the
    # two selects per bounce are pure cost, so gate on scene.has_accel
    # (static, free at trace time).
    if not ZERO_DEAD_DIRS or not scene.has_accel:
        return o, d
    z = V3.zeros(alive.shape)
    far = V3(z.x + DEAD_PARK, z.y + DEAD_PARK, z.z + DEAD_PARK)
    return vec3.where(alive, o, far), vec3.where(alive, d, z)

# Forward renders use the regenerating wavefront (trace_regenerative) instead
# of the lockstep chunk scan (trace-time switch).
REGEN_FORWARD = True


def _media_uniforms(scene, pixel_ids, sample_ids, bounce, seed):
    """One uniform per (ray, medium) for free-flight sampling; lanes
    DIM_MEDIUM + 2*m keep media draws independent of everything else."""
    n_media = scene.n_media
    if not n_media:
        return jnp.zeros((pixel_ids.shape[0], 0), jnp.float32)
    cols = []
    for m in range(n_media):
        u, _ = rng.uniform2(seed, pixel_ids, sample_ids, bounce, rng.DIM_MEDIUM + 2 * m)
        cols.append(u)
    return jnp.stack(cols, axis=-1)


def _advance(scene, o, d, time, throughput, alive, pixel_ids, sample_ids,
             bounce, seed, t_min, remat=False, fast_texel=False):
    """THE bounce contract (engine.h:447-466), shared by the lockstep scan
    (`_bounce`) and the regenerating wavefront (`trace_regenerative`):
    winner search, miss -> background, emission, branchless scatter.

    Masking note: the radiance delta adds the miss and emission terms as
    one value, but the masks (alive & ~hit vs alive & hit) are disjoint and
    the masked-out term is exactly 0.0, so accumulating the sum is
    bit-identical to accumulating the two terms in sequence.

    ``remat``: rematerialize the shading stage (winner recompute + textures
    + scatter) in the backward pass.  The stage is a cheap pure function of
    (o, d, t, kind, idx), so checkpointing it shrinks the per-bounce scan
    residuals to roughly that tuple.

    Returns (radiance_delta V3, hit_p V3, new_dir V3, attenuation V3,
    scattered [B] bool = alive & hit & scatter_ok).
    """
    u_media = _media_uniforms(scene, pixel_ids, sample_ids, bounce, seed)
    # Winner selection is a detached discrete decision: run the whole
    # [B, N] sweep (and any BVH traversal) outside the differentiation path —
    # backward only sees the per-ray winner recompute in make_hit_record,
    # which re-derives t differentiably from primitive parameters.
    sg = jax.lax.stop_gradient
    # Dead lanes keep their last ray in the lockstep carry; zero their
    # directions and park their origins outside the scene so they miss every
    # primitive/AABB instead of dragging real intersection work along.
    # Results for dead lanes are discarded by the alive masks below either
    # way.
    o_live, d_live = _park_dead(scene, alive, o, d)
    t, kind, idx = intersect.closest_hit(
        sg(scene), sg(o_live), sg(d_live), sg(time), u_media, t_min
    )
    hit = (kind >= 0) & alive

    # Miss -> background * throughput, then die (engine.h:455-457).
    miss_now = alive & ~hit
    bg = V3.from_array(scene.background)
    zero = V3.zeros(miss_now.shape)
    delta = vec3.where(miss_now, throughput * bg, zero)

    def shade_hit(scene, o, d, time, t, kind, idx, u_media):
        rec = intersect.make_hit_record(scene, o, d, time, t, kind, idx, u_media,
                                        t_min=t_min)
        # Emission accumulates for every live hit (engine.h:460-465); fused
        # with scatter so the material table and texture are read once.
        if FUSE_SHADE:
            emit, new_dir, attenuation, scatter_ok = shade.emit_and_scatter(
                scene, rec, d, pixel_ids, sample_ids, bounce, seed, fast_texel
            )
        else:
            emit = shade.emitted(scene, rec, fast_texel)
            new_dir, attenuation, scatter_ok = shade.scatter(
                scene, rec, d, pixel_ids, sample_ids, bounce, seed, fast_texel
            )
        return emit, rec.p, new_dir, attenuation, scatter_ok

    if remat:
        shade_hit = jax.checkpoint(shade_hit)
    emit, hit_p, new_dir, attenuation, scatter_ok = shade_hit(
        scene, o, d, time, t, kind, idx, u_media
    )

    delta = delta + vec3.where(hit, throughput * emit, zero)
    scattered = hit & scatter_ok
    return delta, hit_p, new_dir, attenuation, scattered


def _bounce(scene, carry, bounce, pixel_ids, sample_ids, seed, t_min,
            remat=False, fast_texel=False):
    """One lockstep wavefront bounce; returns the updated carry."""
    o, d, time, throughput, radiance, alive, segments = carry
    delta, hit_p, new_dir, attenuation, scattered = _advance(
        scene, o, d, time, throughput, alive, pixel_ids, sample_ids, bounce,
        seed, t_min, remat=remat, fast_texel=fast_texel
    )
    radiance = radiance + delta
    alive = scattered
    throughput = vec3.where(alive, throughput * attenuation, throughput)
    o = vec3.where(alive, hit_p, o)
    d = vec3.where(alive, new_dir, d)
    segments = segments + jnp.sum(alive.astype(jnp.int32))
    return (o, d, time, throughput, radiance, alive, segments)


def _regen_loop_parts(scene, cam, pix_ids, seed, width, height,
                      sample_stride, limit, max_depth, t_min):
    """(cam_rays, body) of the regenerating wavefront, bound to one
    lane->pixel assignment.  Stage 2+ of the compacting wavefront rebinds to
    the gathered survivor pixels — the bounce contract itself is
    width-agnostic."""
    from another_raytracer.ops import camera as camera_lib

    needs_time = scene.has_motion

    def cam_rays(sample_ids):
        return camera_lib.generate_rays(
            cam, pix_ids, sample_ids, width, height, seed,
            needs_time=needs_time)

    def body(state):
        (o, d, time, throughput, total, path_rad, alive, sample, bounce,
         segments) = state

        delta, hit_p, new_dir, attenuation, scattered = _advance(
            scene, o, d, time, throughput, alive, pix_ids, sample, bounce,
            seed, t_min, fast_texel=True
        )
        path_rad = path_rad + delta
        throughput = vec3.where(scattered, throughput * attenuation, throughput)
        o = vec3.where(scattered, hit_p, o)
        d = vec3.where(scattered, new_dir, d)
        bounce = jnp.where(alive, bounce + 1, bounce)
        # Depth exhaustion contributes nothing further (engine.h:451-452).
        alive_next = scattered & (bounce < max_depth)
        # Count every scatter (even depth-capped ones) — the same convention
        # as the lockstep loop, which counts alive-after-scatter at each of
        # its fixed max_depth steps, so segment totals agree across paths.
        segments = segments + jnp.sum(scattered.astype(jnp.int32))

        # Fold finished paths into the lane total as one value — the same
        # floating-point add grouping as the lockstep chunk scan (acc +=
        # whole-sample radiance), keeping the two paths bit-identical.
        ended = alive & ~alive_next
        total = total + vec3.where(ended, path_rad, V3.zeros(ended.shape))
        path_rad = vec3.where(ended, V3.zeros(ended.shape), path_rad)

        # Re-arm ended lanes with their next sample's primary ray.
        next_sample = jnp.where(ended, sample + jnp.uint32(sample_stride), sample)
        regen = ended & (next_sample < limit)
        o2, d2, time2 = cam_rays(next_sample)
        o = vec3.where(regen, o2, o)
        d = vec3.where(regen, d2, d)
        time = jnp.where(regen, time2, time)
        one = jnp.ones_like(throughput.x)
        throughput = vec3.where(regen, V3(one, one, one), throughput)
        bounce = jnp.where(regen, 0, bounce)
        alive_next = alive_next | regen
        sample = next_sample
        segments = segments + jnp.sum(regen.astype(jnp.int32))
        return (o, d, time, throughput, total, path_rad, alive_next,
                sample, bounce, segments)

    return cam_rays, body


def _regen_initial_state(cam_rays, pixel_ids, sample_ids0, limit):
    """Initial 10-tuple carry of the regenerating wavefront."""
    o, d, time = cam_rays(sample_ids0)
    # Bind every carry component to d's varying-axes type (see trace): the
    # pinhole origin / zero shutter time are replicated constants and the
    # initial sample ids vary only over the sample axis.
    z = d.x * 0.0
    ones = z + 1.0
    o = V3(o.x + z, o.y + z, o.z + z)
    time = time + z
    sample = sample_ids0 + (pixel_ids * 0)
    alive = (z < 1.0) & (sample < limit)
    return (
        o, d, time,
        V3(ones, ones, ones),  # throughput
        V3(z, z, z),  # total radiance (finished paths, summed per path)
        V3(z, z, z),  # current path's radiance
        alive,
        sample,
        jnp.zeros_like(sample),  # bounce within current path
        jnp.sum(alive.astype(jnp.int32)),  # segments
    )


def trace_regenerative(scene, cam, pixel_ids, sample_ids0, seed, *,
                       width: int, height: int, sample_stride: int,
                       sample_end, spp_cap, max_depth: int, t_min: float):
    """Forward-only wavefront with per-lane sample regeneration.

    Lockstep tracing (``trace``) runs chunks x max_depth bounce steps with
    every lane padded to the deepest path — with a few average segments per
    primary that is mostly dead-lane work.  Here each lane owns
    a (pixel, sample-arithmetic-progression) work list: the moment its path
    terminates, the lane re-arms with the next sample's camera ray (pure
    per-lane arithmetic — counter-based RNG keyed on absolute (pixel,
    sample, bounce), camera evaluation, no cross-lane traffic).  One
    while_loop replaces both the outer sample scan and the bounce loop, and
    iteration count tracks max-over-lanes total segments instead of
    chunks x depth.

    Radiance is BIT-IDENTICAL to the lockstep path: each lane accumulates
    its samples' contributions in the same (sample, bounce) lexicographic
    order, with the same RNG draws (tests/test_regen.py).

    Not differentiable (data-dependent trip count); the scan path remains
    the gradient route.

    Args:
      sample_ids0: [B] first sample id per lane.
      sample_stride: per-lane sample step (the samples_per_pass layout:
        lane (s, p) owns samples s, s+stride, ...).
      sample_end, spp_cap: lane sample ids must stay < min(both).

    Returns (radiance V3 [B] per-lane sums, segments int32).
    """
    limit = jnp.minimum(jnp.uint32(sample_end), jnp.uint32(spp_cap))
    B = pixel_ids.shape[0]

    def make_loop(pix_ids):
        return _regen_loop_parts(scene, cam, pix_ids, seed, width, height,
                                 sample_stride, limit, max_depth, t_min)

    cam_rays, body = make_loop(pixel_ids)
    state = _regen_initial_state(cam_rays, pixel_ids, sample_ids0, limit)

    # ---- Staged tail compaction ------------------------------------------
    # The wavefront's trip count is max-over-lanes TOTAL segments; one deep
    # pixel keeps the full-width body running long after most lanes have
    # exhausted their samples.  So:
    # run each stage only while the alive count still justifies its width,
    # then gather the survivors (with their RUNNING per-lane totals, so each
    # pixel's accumulation chain — and bit-equality with the lockstep path —
    # is preserved) into a ~8x narrower buffer and continue there.  The
    # compaction itself is one-time work: a cumsum + searchsorted rank
    # select + one row gather per carry, against the mostly-dead full-width
    # tail iterations it replaces.
    widths = [B]
    if REGEN_COMPACT:
        while widths[-1] >= REGEN_COMPACT_MIN_B:
            nxt = -(-widths[-1] // REGEN_COMPACT_SHRINK)
            nxt = -(-nxt // REGEN_COMPACT_ALIGN) * REGEN_COMPACT_ALIGN
            if nxt >= widths[-1]:
                break
            widths.append(nxt)

    pix = pixel_ids
    backmaps = []  # (parent_total V3, scatter_idx [w_child], w_parent)
    for i, w in enumerate(widths):
        _, body = make_loop(pix)
        if i + 1 < len(widths):
            cap = widths[i + 1]
            # The alive count only ever shrinks (a lane that exhausts its
            # samples never re-arms), so the loop exits the first time
            # count <= cap//2 — always within the next buffer's capacity.
            thresh = jnp.int32(cap // 2)

            def cond(state, _t=thresh):
                return jnp.sum(state[6].astype(jnp.int32)) > _t

            state = jax.lax.while_loop(cond, body, state)

            (o, d, time, throughput, total, path_rad, alive, sample, bounce,
             segments) = state
            csum = jnp.cumsum(alive.astype(jnp.int32))
            count = csum[-1]
            ranks = jnp.arange(1, cap + 1, dtype=jnp.int32)
            # src[j] = index of the (j+1)-th alive lane; ranks beyond count
            # return w — clip for the gathers, drop for the scatter-back.
            src = jnp.searchsorted(csum, ranks, side="left")
            valid = ranks <= count
            srcc = jnp.minimum(src, w - 1)
            take = lambda a: a[srcc]  # noqa: E731
            zero = jnp.zeros((cap,), total.x.dtype)
            state = (
                o.map(take), d.map(take), take(time), throughput.map(take),
                # Child totals CONTINUE the gathered lanes' running sums —
                # the scatter-back replaces the parent slot wholesale.
                vec3.where(valid, total.map(take), V3(zero, zero, zero)),
                vec3.where(valid, path_rad.map(take), V3(zero, zero, zero)),
                valid,  # gathered lanes are alive by construction
                take(sample), take(bounce), segments,
            )
            # Invalid lanes scatter out-of-bounds (mode="drop"); give each a
            # DISTINCT sentinel (w + rank, all >= w) so the
            # unique_indices=True promise holds even for dropped lanes —
            # a shared sentinel would be formally undefined behavior.
            backmaps.append((total, jnp.where(valid, srcc, w + ranks), w))
            pix = take(pix)
        else:
            def cond(state):
                return jnp.any(state[6])

            state = jax.lax.while_loop(cond, body, state)

    total, segments = state[4], state[9]
    for parent_total, idx, w in reversed(backmaps):
        put = lambda pa, ch: pa.at[idx].set(  # noqa: E731
            ch, mode="drop", unique_indices=True)
        total = V3(put(parent_total.x, total.x), put(parent_total.y, total.y),
                   put(parent_total.z, total.z))
    return total, segments


def trace(scene, o: V3, d: V3, time, pixel_ids, sample_ids, seed, max_depth: int,
          t_min: float, differentiable: bool = False, remat: bool = False,
          unroll: "int | None" = None, alive0=None):
    """Trace a ray batch to completion.

    Returns (radiance V3 of [B], segments [] int32 — total alive ray
    segments summed over bounces, the honest bounce-ray count for rays/s
    metrics).

    ``remat``: rematerialize each bounce's shading stage in the backward
    pass instead of storing its residuals (trades a small recompute for
    per-bounce residual HBM traffic; only meaningful with
    ``differentiable=True``).

    ``alive0`` ([B] bool, optional): lanes where False start dead — they
    trace nothing, count no segments and return zero radiance (samples past
    the range, padding lanes).
    """
    # Derive the initial carry from the ray *direction* rather than fresh
    # constants: under shard_map the loop carry must enter with the same
    # varying-axes type it exits with (check_vma=True).  d is always
    # pixel-derived hence device-varying; o can be a replicated constant
    # (lens-less camera origin) so it is bound to d's type too.  All of this
    # folds away in compilation.
    z = d.x * 0.0
    ones = z + 1.0
    alive = z < 1.0  # all-true, varying like d.x
    if alive0 is not None:
        alive = alive & alive0
    o = V3(o.x + z, o.y + z, o.z + z)
    carry = (
        o, d, time,
        V3(ones, ones, ones),
        V3(z, z, z),
        alive,
        jnp.sum(alive.astype(jnp.int32)),  # == B: primary segments all alive
    )

    if differentiable:
        # Default: fully unroll the bounce scan.  A rolled scan writes [1, B]
        # residual rows into [depth, B] buffers one dynamic-update-slice at
        # a time; unrolled, residuals are plain values written once.  The
        # outer sample-pass scan stays rolled (chunk_unroll=1).
        if unroll is None:
            unroll = max_depth

        def body(c, bounce):
            # differentiable path: fast_texel stays False (texel gradients
            # flow only through the row gather)
            return _bounce(scene, c, bounce, pixel_ids, sample_ids, seed, t_min,
                           remat=remat), None
        carry, _ = jax.lax.scan(body, carry, jnp.arange(max_depth, dtype=jnp.uint32),
                                unroll=unroll)
    else:
        def cond(state):
            bounce, c = state
            return (bounce < max_depth) & jnp.any(c[5])

        def body(state):
            bounce, c = state
            c = _bounce(scene, c, bounce.astype(jnp.uint32), pixel_ids,
                        sample_ids, seed, t_min, fast_texel=True)
            return (bounce + 1, c)

        _, carry = jax.lax.while_loop(cond, body, (jnp.int32(0), carry))

    radiance, segments = carry[4], carry[6]
    return radiance, segments
