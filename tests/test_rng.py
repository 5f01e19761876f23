"""Counter-based RNG: known-answer vectors + device/oracle agreement."""

import jax.numpy as jnp
import numpy as np

from another_raytracer.ops import rng
from another_raytracer.oracle import cpu_reference as oracle


def test_threefry_known_vectors():
    # Random123 reference vectors for threefry2x32, 20 rounds (the rendering
    # draws use rng.ROUNDS=13; the 20-round path pins the loop refactor to
    # the published algorithm).
    x0, x1 = rng.threefry2x32(
        jnp.uint32(0), jnp.uint32(0), jnp.uint32(0), jnp.uint32(0), rounds=20
    )
    assert int(x0) == 0x6B200159 and int(x1) == 0x99BA4EFE

    x0, x1 = rng.threefry2x32(
        jnp.uint32(0xFFFFFFFF), jnp.uint32(0xFFFFFFFF),
        jnp.uint32(0xFFFFFFFF), jnp.uint32(0xFFFFFFFF), rounds=20,
    )
    assert int(x0) == 0x1CB996FC and int(x1) == 0xBB002BE7

    x0, x1 = rng.threefry2x32(
        jnp.uint32(0x13198A2E), jnp.uint32(0x03707344),
        jnp.uint32(0x243F6A88), jnp.uint32(0x85A308D3), rounds=20,
    )
    assert int(x0) == 0xC4923A9C and int(x1) == 0x483DF7A0


def test_oracle_matches_device_bits():
    px = np.arange(1000, dtype=np.uint32)
    samp = (px * 7 + 3).astype(np.uint32)
    for bounce, dim in [(0, 0), (3, 2), (rng.CAMERA_BOUNCE, 4)]:
        d0, d1 = rng.uniform2(7, jnp.asarray(px), jnp.asarray(samp), bounce, dim)
        o0, o1 = oracle.uniform2(7, px, samp, bounce, dim)
        np.testing.assert_array_equal(np.asarray(d0, np.float64), o0)
        np.testing.assert_array_equal(np.asarray(d1, np.float64), o1)


def test_uniform_range_and_spread():
    px = np.arange(1 << 14, dtype=np.uint32)
    u, v = rng.uniform2(0, jnp.asarray(px), jnp.zeros_like(jnp.asarray(px)), 0, 0)
    u = np.asarray(u)
    v = np.asarray(v)
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.01 and abs(v.mean() - 0.5) < 0.01
    # lanes decorrelated
    assert abs(np.corrcoef(u, v)[0, 1]) < 0.05


def test_shard_invariance():
    """A pixel's draw doesn't depend on batch position — the property that
    makes renders identical under any tile/spp sharding."""
    px = np.arange(64, dtype=np.uint32)
    u_full, _ = rng.uniform2(1, jnp.asarray(px), jnp.zeros(64, jnp.uint32), 2, 0)
    u_half, _ = rng.uniform2(1, jnp.asarray(px[32:]), jnp.zeros(32, jnp.uint32), 2, 0)
    np.testing.assert_array_equal(np.asarray(u_full)[32:], np.asarray(u_half))
