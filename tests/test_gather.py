"""One-hot-matmul table lookups must match plain gathers exactly."""

import numpy as np
import jax.numpy as jnp

from another_raytracer.ops import gather


def test_dense_matches_gather():
    rng = np.random.default_rng(0)
    K, B = 37, 5000
    idx = jnp.asarray(rng.integers(0, K, B), jnp.int32)
    f = jnp.asarray(rng.normal(size=K), jnp.float32)
    i = jnp.asarray(rng.integers(0, 1 << 20, K), jnp.int32)

    look = gather.Lookup(idx, K)
    assert look.dense
    gf, gi = look(f, i)
    np.testing.assert_array_equal(np.asarray(gf), np.asarray(f)[np.asarray(idx)])
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(i)[np.asarray(idx)])
    assert gi.dtype == jnp.int32


def test_large_table_falls_back():
    K = gather.MAX_ONEHOT_K + 1
    idx = jnp.asarray([0, K - 1, 5], jnp.int32)
    t = jnp.arange(K, dtype=jnp.float32)
    look = gather.Lookup(idx, K)
    assert not look.dense
    (g,) = look(t)
    np.testing.assert_array_equal(np.asarray(g), [0, K - 1, 5])


def test_v3_lookup():
    rng = np.random.default_rng(1)
    K, B = 12, 100
    tab = jnp.asarray(rng.normal(size=(K, 3)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, K, B), jnp.int32)
    v = gather.Lookup(idx, K).v3(tab)
    np.testing.assert_array_equal(np.asarray(v.x), np.asarray(tab)[np.asarray(idx), 0])
    np.testing.assert_array_equal(np.asarray(v.z), np.asarray(tab)[np.asarray(idx), 2])
