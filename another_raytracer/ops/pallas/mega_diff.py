"""Fused differentiable forward path: megakernel primal + replay backward.

Differentiating the XLA wavefront re-runs the full closest-hit sweep and
shading to build autodiff residuals.  For the scene class where the
radiance is an explicit multiplicative chain — lambertian, metal,
dielectric and diffuse-light materials with solid/checker textures,
sweep-regime geometry (the Cornell box) — none of that is necessary:

  L_lane = sum_chains sum_k (prod_{j<k} a[t_j]) * x_k,
  x_k = ca[t_k] (light hit) or background (miss),

so the complete gradient w.r.t. the shading parameters is a function of
(a) the per-iteration winner TEXTURE ids and event flags and (b) the
current parameter values.  The forward pass therefore runs the
whole-wavefront megakernel (ops/pallas/mega_kernel.py) with residual
recording (one int32 code row per bounce step: tex_id*16 +
checker_odd*8 + chain_end*4 + event, plus the iteration-entry
throughput), and the backward is a cheap pure-XLA replay over those codes:
a reverse scan of suffix values R (R <- x + a*R, zeroed at chain ends),
accumulating cot(a_i) = ghat * T_prev_i * R_after_i into per-texture
per-lane accumulators, then one reduction per (texture, channel).

No sweep, no hit-record recompute, no shading math in the backward.

Gradient scope (by construction of the gate): d/d tex_ca, d/d tex_cb
and d/d background are EXACT — they are the only parameters the radiance
depends on CONTINUOUSLY for this scene class.  A metal scatter multiplies
by its albedo texture exactly like lambertian (same cotangent routing); a
dielectric scatter multiplies by the constant (1,1,1) (sentinel tid =
n_textures); a metal absorption ends the chain at value zero (ev=0 + end
bit).  d/d mat_fuzz and d/d mat_ir are zero under the detached estimator
for solid/checker scenes — fuzz/ir enter only through scatter DIRECTIONS,
and with piecewise-constant textures the radiance value is a product of
texture constants independent of hit positions; XLA autodiff of the scan
path returns exactly zero too (verified in tests/test_mega_diff.py), so
the fused zeros are not an approximation.  Geometry cotangents (sphere
centers, rect params) are returned as ZERO and the enable gate refuses
geometry-trainable sets (see enabled()).

Numerics: the primal is the megakernel (ulp-level transcendental
divergence from XLA); the gradients are exact functions of the recorded
winners + parameters, verified against XLA autodiff in
tests/test_mega_diff.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from another_raytracer.models import scene as scene_lib
from another_raytracer.ops.pallas import mega_kernel
from another_raytracer.ops.vec3 import V3

# Trace-time knob: None = auto (GPU + supports_diff), False = off,
# True = force.
FUSED_DIFF = None
# Run a forced fused path's kernel in the Pallas interpreter (CPU tests).
# Never set automatically.
INTERPRET = False

# Residual memory bound: codes [iters, B] int32 + T_prev 3x[iters, B] f32
# live in device memory between the forward and the backward pass.
RESIDUAL_BYTES_PER_ENTRY = 16
MAX_RESIDUAL_BYTES = 2 << 30
MAX_TEXTURES = 16

# Scene leaves whose cotangents the fused path handles EXACTLY for the
# supported scene class: tex_ca/tex_cb/background carry the full gradient
# (the radiance is an explicit function of them); tex_cc, mat_fuzz,
# mat_ir and atlas are genuinely unused by lambertian/diffuse-light +
# solid/checker scenes, so their true gradient is zero.  Geometry leaves
# (sphere centers, rect bounds, ...) are NOT here: the fused path returns
# hard-zero cotangents for them by construction, so a caller training
# geometry must not take this path (enabled() enforces that).
SAFE_TRAINABLE = frozenset({
    "tex_ca", "tex_cb", "tex_cc", "mat_fuzz", "mat_ir", "atlas",
    "background",
})


def residual_bytes(spp_cap: int, sample_stride: int, max_depth: int,
                   n_lanes: int) -> int:
    """Device bytes of the recorded residuals for one fused forward."""
    per_lane_samples = -(-int(spp_cap) // max(int(sample_stride), 1))
    return (RESIDUAL_BYTES_PER_ENTRY * per_lane_samples * int(max_depth)
            * int(n_lanes))


def supports_diff(scene, cam, spp_cap: int, sample_stride: int,
                  max_depth: int, n_lanes: int) -> bool:
    return (
        mega_kernel.supports(scene, cam)
        and residual_bytes(spp_cap, sample_stride, max_depth, n_lanes)
        <= MAX_RESIDUAL_BYTES
    )


def enabled(scene, cam, spp_cap, sample_stride, max_depth, n_lanes,
            trainable=None) -> bool:
    """Should the fused path run for this render?

    ``trainable`` is the caller's trainable-leaf names (grad/diff.py
    threads them through render_loss -> radiance_batch).  The fused path
    returns hard-zero geometry cotangents, so:

      * auto mode (FUSED_DIFF=None) engages ONLY when the caller declared
        a trainable set that is a subset of SAFE_TRAINABLE — an unknown
        (None) trainable set never auto-engages, closing the
        silently-zero-geometry-gradient path;
      * forced mode (FUSED_DIFF=True) raises if a declared trainable set
        contains a geometry leaf, instead of silently zeroing it.
    """
    if FUSED_DIFF is False:
        return False
    safe = set(SAFE_TRAINABLE)
    # Geometry leaves of primitive kinds the supported scene class CANNOT
    # contain (supports() excludes triangle/medium scenes) have a true
    # gradient of zero, so training them through this path is exact.
    safe |= {"tri_v0", "tri_v1", "tri_v2", "tri_uv0", "tri_uv1", "tri_uv2",
             "med_a", "med_b", "med_neg_inv_density"}
    geom = (None if trainable is None
            else sorted(set(trainable) - safe))
    ok = supports_diff(scene, cam, spp_cap, sample_stride, max_depth, n_lanes)
    if FUSED_DIFF is True:
        if not ok:
            raise ValueError("FUSED_DIFF forced on but unsupported")
        if geom:
            raise ValueError(
                "FUSED_DIFF forced on, but the trainable set includes "
                f"geometry leaves {geom} whose cotangents the fused path "
                "zeroes by construction; set mega_diff.FUSED_DIFF = False "
                "for geometry training")
        return True
    # The kernel's one backend choice (GPU only) decides for the primal.
    return ok and geom == [] and mega_kernel.enabled(scene, cam)


def _zero_cot(x):
    if jnp.issubdtype(jnp.result_type(x), jnp.floating):
        return jnp.zeros_like(x)
    return np.zeros(np.shape(x), jax.dtypes.float0)


def _bwd_large(scene, codes, tprev, ghat, ca, cb, bg, bgv, has_checker,
               has_metal, decode, cam, pixel_ids, sample_ids0):
    """Reverse replay for scenes with many textures (see the call site)."""
    T = ca.shape[0]
    iters, B = codes.shape
    tid_all = codes >> 4  # [iters, B] in [0, T]
    ones = jnp.ones((1,), ca.dtype)
    # Per-channel albedo xs, gathered once: a [iters*B]-indexed read of a
    # [T+1] table per channel (rule-8 cost is paid once here, not per
    # texture per iteration).
    flat = tid_all.reshape(-1)
    a_ch = []
    for c in range(3):
        cac = jnp.concatenate([ca[:, c], ones])[flat]
        if has_checker:
            cbc = jnp.concatenate([cb[:, c], ones])[flat]
            odd_flat = ((codes.reshape(-1) & 8) != 0)
            cac = jnp.where(odd_flat, cbc, cac)
        a_ch.append(cac.reshape(iters, B))

    zeros = jnp.zeros_like(ghat[0])
    gt0 = jnp.zeros((T + 1,), ca.dtype)

    def bwd_body(carry, x):
        r, gca, gcb, gbg = carry
        row, tpx, tpy, tpz, ax, ay, az, tid = x
        a = (ax, ay, az)
        tp_prev = (tpx, tpy, tpz)
        ev, end, odd, _ = decode(row)
        scat = ev == 1
        light = ev == 2
        miss = ev == 3
        r_after = tuple(jnp.where(end, 0.0, r[c]) for c in range(3))
        gterm = tuple(ghat[c] * tp_prev[c] for c in range(3))
        gbg = tuple(gbg[c] + jnp.where(miss, gterm[c], 0.0) for c in range(3))
        gsc = tuple(gterm[c] * r_after[c] for c in range(3))
        contrib = tuple(
            jnp.where(scat, gsc[c], 0.0) + jnp.where(light, gterm[c], 0.0)
            for c in range(3))
        if has_checker:
            gca = tuple(
                gca[c].at[tid].add(jnp.where(odd, 0.0, contrib[c]),
                                   mode="drop")
                for c in range(3))
            gcb = tuple(
                gcb[c].at[tid].add(jnp.where(odd, contrib[c], 0.0),
                                   mode="drop")
                for c in range(3))
        else:
            gca = tuple(gca[c].at[tid].add(contrib[c], mode="drop")
                        for c in range(3))
        r = tuple(
            jnp.where(scat, a[c] * r_after[c],
                      jnp.where(light, a[c],
                                jnp.where(miss, bgv[c], r[c])))
            for c in range(3))
        if has_metal:
            dead_end = (ev == 0) & end
            r = tuple(jnp.where(dead_end, 0.0, r[c]) for c in range(3))
        return (r, gca, gcb, gbg), None

    gcb0 = (gt0, gt0, gt0) if has_checker else ()
    (r, gca, gcb, gbg), _ = jax.lax.scan(
        bwd_body,
        ((zeros, zeros, zeros), (gt0, gt0, gt0), gcb0,
         (zeros, zeros, zeros)),
        (codes, tprev[0], tprev[1], tprev[2],
         a_ch[0], a_ch[1], a_ch[2], tid_all),
        reverse=True, unroll=8)

    grad_ca = jnp.stack([g[:T] for g in gca], axis=1)
    grad_cb = (jnp.stack([g[:T] for g in gcb], axis=1) if has_checker
               else jnp.zeros_like(cb))
    grad_bg = jnp.stack([jnp.sum(gbg[c]) for c in range(3)])

    scene_bar = jax.tree.map(_zero_cot, scene)
    scene_bar = scene_bar.replace(
        tex_ca=grad_ca.astype(ca.dtype), tex_cb=grad_cb.astype(ca.dtype),
        background=grad_bg.astype(bg.dtype))
    cam_bar = jax.tree.map(_zero_cot, cam)
    return (scene_bar, cam_bar, _zero_cot(pixel_ids), _zero_cot(sample_ids0),
            np.zeros((), jax.dtypes.float0))


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _traced(cfg, scene, cam, pixel_ids, sample_ids0, seed):
    out, _ = _traced_fwd(cfg, scene, cam, pixel_ids, sample_ids0, seed)
    return out


def _traced_fwd(cfg, scene, cam, pixel_ids, sample_ids0, seed):
    (width, height, sample_stride, spp_cap, max_depth, t_min, record_iters,
     interpret) = cfg
    total, segments, codes, tprev = mega_kernel.trace_regenerative_mega(
        scene, cam, pixel_ids, sample_ids0, seed,
        width=width, height=height, sample_stride=sample_stride,
        sample_end=spp_cap, spp_cap=spp_cap, max_depth=max_depth,
        t_min=t_min, interpret=interpret, record_iters=record_iters,
    )
    res = (codes, tprev, scene.tex_ca, scene.tex_cb, scene.background,
           scene, cam, pixel_ids, sample_ids0)
    return (total, segments), res


def _traced_bwd(cfg, res, cot):
    codes, tprev_v3, ca, cb, bg, scene, cam, pixel_ids, sample_ids0 = res
    cot_total, _cot_segments = cot
    ghat = (cot_total.x, cot_total.y, cot_total.z)  # [B] per channel
    tprev = (tprev_v3.x, tprev_v3.y, tprev_v3.z)  # [iters, B] each
    T = ca.shape[0]
    cav = [tuple(ca[t, c] for c in range(3)) for t in range(T)]
    cbv = [tuple(cb[t, c] for c in range(3)) for t in range(T)]
    bgv = tuple(bg[c] for c in range(3))
    # STATIC gates: scenes without checker textures skip the odd-bit
    # machinery entirely; likewise metal/dielectric handling.
    has_checker = scene_lib.TEX_CHECKER in scene.tex_kinds
    has_metal = scene_lib.MAT_METAL in scene.mat_kinds
    has_diel = scene_lib.MAT_DIELECTRIC in scene.mat_kinds

    def decode(row):
        ev = row & 3
        end = (row & 4) != 0
        # checker odd cell won (routes cot to tex_cb)
        odd = ((row & 8) != 0) if has_checker else False
        tid = row >> 4
        return ev, end, odd, tid

    def albedo(tid, odd):
        # T is tiny and static: masked select-sum, no gathers.
        out = [jnp.zeros_like(ghat[0]) for _ in range(3)]
        for t in range(T):
            m = tid == t
            for c in range(3):
                val = (jnp.where(odd, cbv[t][c], cav[t][c])
                       if has_checker else cav[t][c])
                out[c] = jnp.where(m, val, out[c])
        if has_diel:
            # Sentinel tid == T: dielectric scatter, attenuation (1,1,1)
            # (material.h:77-79) — no albedo cotangent routed (the
            # contribution loops only cover tid < T).
            m = tid == T
            out = [jnp.where(m, 1.0, out[c]) for c in range(3)]
        return out

    if T > MAX_TEXTURES:
        # LARGE-T replay (sweep scenes with more than MAX_TEXTURES
        # textures, e.g. one solid color per sphere): the per-texture select-sum
        # above is O(T) elementwise work per lane per iteration — instead, gather
        # the per-iteration albedo channels ONCE outside the scan
        # ([iters*B]-indexed reads of [T+1] per-channel tables; the +1
        # sentinel row of ones is the dielectric unit attenuation), and
        # accumulate cotangents with per-iteration scatter-adds into
        # [T+1]-per-channel tables carried through the scan (contributions
        # for the sentinel row land there and are sliced off).
        return _bwd_large(scene, codes, tprev, ghat, ca, cb, bg, bgv,
                          has_checker, has_metal, decode, cam,
                          pixel_ids, sample_ids0)

    # ---- reverse replay: suffix values + gradient accumulation ------------
    # (prefix throughputs T_prev come straight from the kernel's residual
    # rows — no forward replay, no [iters, B] stacking in XLA)
    zeros = jnp.zeros_like(ghat[0])
    acc0 = tuple(tuple(zeros for _ in range(3)) for _ in range(T))

    def bwd_body(carry, x):
        r, acc, accb, gbg = carry
        row, tpx, tpy, tpz = x
        tp_prev = (tpx, tpy, tpz)
        ev, end, odd, tid = decode(row)
        a = albedo(tid, odd)
        scat = ev == 1
        light = ev == 2
        miss = ev == 3
        r_after = tuple(jnp.where(end, 0.0, r[c]) for c in range(3))
        # terminal-event cotangents: cot(x_i) = ghat * T_prev
        gterm = tuple(ghat[c] * tp_prev[c] for c in range(3))
        gbg = tuple(gbg[c] + jnp.where(miss, gterm[c], 0.0) for c in range(3))
        # scatter cotangent: cot(a_i) = ghat * T_prev * R_after
        gsc = tuple(gterm[c] * r_after[c] for c in range(3))
        contrib = tuple(
            tuple(
                jnp.where((tid == t) & scat, gsc[c], 0.0)
                + jnp.where((tid == t) & light, gterm[c], 0.0)
                for c in range(3))
            for t in range(T))
        if has_checker:
            acc = tuple(
                tuple(acc[t][c] + jnp.where(odd, 0.0, contrib[t][c])
                      for c in range(3))
                for t in range(T))
            accb = tuple(
                tuple(accb[t][c] + jnp.where(odd, contrib[t][c], 0.0)
                      for c in range(3))
                for t in range(T))
        else:
            acc = tuple(
                tuple(acc[t][c] + contrib[t][c] for c in range(3))
                for t in range(T))
        # suffix update R <- x_i + a_i * R_after
        r = tuple(
            jnp.where(scat, a[c] * r_after[c],
                      jnp.where(light, a[c],
                                jnp.where(miss, bgv[c], r[c])))
            for c in range(3))
        if has_metal:
            # Metal absorption (material.h:52-55): the kernel emits ev=0
            # WITH the end bit — the chain dies contributing nothing, so
            # the suffix value is exactly zero.  (In the lambertian class
            # ev=0∧end never occurs; idle dead rows are ev=0 without end
            # and remain no-ops.)
            dead_end = (ev == 0) & end
            r = tuple(jnp.where(dead_end, 0.0, r[c]) for c in range(3))
        return (r, acc, accb, gbg), None

    accb0 = acc0 if has_checker else ()
    (r, acc, accb, gbg), _ = jax.lax.scan(
        bwd_body, ((zeros, zeros, zeros), acc0, accb0,
                   (zeros, zeros, zeros)),
        (codes, tprev[0], tprev[1], tprev[2]), reverse=True, unroll=8)

    grad_ca = jnp.stack(
        [jnp.stack([jnp.sum(acc[t][c]) for c in range(3)]) for t in range(T)])
    grad_cb = (jnp.stack(
        [jnp.stack([jnp.sum(accb[t][c]) for c in range(3)])
         for t in range(T)]) if has_checker else jnp.zeros_like(cb))
    grad_bg = jnp.stack([jnp.sum(gbg[c]) for c in range(3)])

    scene_bar = jax.tree.map(_zero_cot, scene)
    scene_bar = scene_bar.replace(
        tex_ca=grad_ca.astype(ca.dtype), tex_cb=grad_cb.astype(ca.dtype),
        background=grad_bg.astype(bg.dtype))
    cam_bar = jax.tree.map(_zero_cot, cam)
    return (scene_bar, cam_bar, _zero_cot(pixel_ids), _zero_cot(sample_ids0),
            np.zeros((), jax.dtypes.float0))


_traced.defvjp(_traced_fwd, _traced_bwd)


def radiance_fused(scene, cam, pixel_ids, sample_ids0, seed, *, width, height,
                   sample_stride, spp_cap, max_depth, t_min,
                   interpret=False):
    """Differentiable (V3 radiance [B], segments) via the fused path.

    ``spp_cap`` is the full static sample budget (the fused path always
    traces the whole [0, spp_cap) range — the bench/training entry points
    do exactly that)."""
    per_lane = -(-int(spp_cap) // max(int(sample_stride), 1))
    record_iters = per_lane * max_depth
    cfg = (width, height, int(sample_stride), int(spp_cap), int(max_depth),
           float(t_min), int(record_iters), bool(interpret))
    return _traced(cfg, scene, cam, jnp.asarray(pixel_ids, jnp.uint32),
                   jnp.asarray(sample_ids0, jnp.uint32), jnp.uint32(seed))
