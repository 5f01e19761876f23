"""Counter-based, stateless RNG for rendering.

The reference uses one process-wide default-seeded ``std::mt19937`` shared by
all threads with no lock (src/utils/tracer_utils.h:27-31) — a data race in
every parallel mode.  Here every random draw is a pure function of
``(seed, pixel, sample, bounce, dim)`` via the public threefry-2x32 block
cipher (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11).
This makes renders deterministic, race-free, and *shard-invariant*: a pixel's
sample sequence does not depend on which device or batch position it lands in.

Everything is vectorized jnp on uint32; no ``jax.random`` keys are threaded
through the integrator (key-splitting per ray would serialize on gathers).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Rotation constants for threefry2x32 (public algorithm constants).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
# np (not jnp) scalar: a module-level jnp array would be a captured
# constant inside Pallas kernels, which pallas_call rejects.
_PARITY = np.uint32(0x1BD11BDA)

# Rounds used for rendering draws.  Salmon et al. (SC'11, Table 2) measure
# threefry-2x32 passing the full BigCrush battery at 13 rounds; 20 is the
# recommended safety margin for cryptographic-adjacent uses.  Monte-Carlo
# rendering draws ~10 uniforms per ray from well-separated counters, so the
# 13-round variant's 35% ALU saving is free quality-wise.  The oracle
# (oracle/cpu_reference.py) reads this constant so device and golden streams
# always agree.
ROUNDS = 13


def _rotl(x, r):
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1, rounds: int = 20):
    """threefry-2x32 PRF: returns two uint32 words.

    All args are uint32 arrays (broadcastable).  This is the same PRF family
    JAX's own PRNG uses; implemented inline so it can run inside any traced
    context (including future Pallas kernels) on raw uint32 lanes.

    ``rounds`` follows Random123 semantics: key injection after every
    complete 4-round group only (a trailing partial group gets no final
    injection), rotation constants cycling through the 8-entry schedule.
    rounds=20 matches the Random123 / jax.random reference vectors.
    """
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    x0 = jnp.asarray(x0, jnp.uint32)
    x1 = jnp.asarray(x1, jnp.uint32)
    ks2 = k0 ^ k1 ^ _PARITY
    keys = (k0, k1, ks2)

    x0 = x0 + k0
    x1 = x1 + k1
    for r in range(rounds):
        x0 = x0 + x1
        x1 = _rotl(x1, _ROTATIONS[r % 8])
        x1 = x0 ^ x1
        if (r + 1) % 4 == 0:
            inject = (r + 1) // 4
            x0 = x0 + keys[inject % 3]
            x1 = x1 + keys[(inject + 1) % 3] + jnp.uint32(inject)
    return x0, x1


def _uniform_from_bits(bits):
    """uint32 -> float32 uniform in [0, 1) using the top 24 bits.

    The value after the shift is < 2**24, so the int32 hop is exact and
    value-identical to a direct uint32->f32 cast, and it keeps the kernel
    lowering to a signed int->float conversion."""
    return (
        (bits >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32)
        * jnp.float32(2.0**-24)
    )


def uniform2(seed, pixel, sample, bounce, dim):
    """Two independent uniforms in [0,1) for lanes (dim) and (dim+1).

    Layout: key = (seed, bounce<<8 | dim), counter = (pixel, sample).
    ``dim`` must be even and < 256; ``bounce`` < 2**24.
    """
    k1 = jnp.uint32((bounce << 8) | dim)
    b0, b1 = threefry2x32(jnp.uint32(seed), k1, pixel, sample, rounds=ROUNDS)
    return _uniform_from_bits(b0), _uniform_from_bits(b1)


def uniform(seed, pixel, sample, bounce, dim):
    """One uniform in [0,1) for the given lane."""
    u, _ = uniform2(seed, pixel, sample, bounce, dim << 1)
    return u


# --- RNG lane (dim) assignments -------------------------------------------
# Camera draws happen before the bounce loop and use bounce = 0xFF00
# (outside the real bounce range).  Scatter draws use the bounce index.
CAMERA_BOUNCE = 0xFF00
DIM_PIXEL_JITTER = 0  # uses lanes 0,1 (sub-pixel jitter u, v)
DIM_LENS = 2  # lanes 2,3 (defocus disk)
DIM_TIME = 4  # lane 4   (shutter time)
DIM_SCATTER_A = 0  # lanes 0,1 per bounce (direction sampling)
DIM_SCATTER_B = 2  # lanes 2,3 per bounce (radius / reflectance prob)
DIM_MEDIUM = 8  # lanes 8.. per bounce (one per medium; 8 + 2*medium_id)
