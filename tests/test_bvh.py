"""BVH: structural invariants of the host build + exhaustive hit-equivalence
of the stackless traversal vs the linear intersect-everything path."""

import numpy as np
import jax.numpy as jnp

from another_raytracer.models import bvh as bvh_lib
from another_raytracer.models.scene import SceneBuilder
from another_raytracer.ops import bvh as bvh_ops
from another_raytracer.ops import intersect
from another_raytracer.ops.vec3 import V3


def random_triangles(n, rng):
    base = rng.uniform(-5, 5, (n, 3))
    return (base,
            base + rng.uniform(-0.6, 0.6, (n, 3)),
            base + rng.uniform(-0.6, 0.6, (n, 3)))


def test_build_invariants():
    rng = np.random.default_rng(0)
    v0, v1, v2 = random_triangles(500, rng)
    tree = bvh_lib.build(*bvh_lib.triangle_bounds(v0, v1, v2))
    # every primitive appears exactly once
    assert sorted(tree.prim_order.tolist()) == list(range(500))
    # escape indices are strictly forward and within bounds
    assert (tree.escape > np.arange(tree.num_nodes)).all()
    assert (tree.escape <= tree.num_nodes).all()
    # leaves small, internal nodes empty
    assert tree.leaf_count.max() <= bvh_lib.LEAF_SIZE
    # parent boxes contain children (check root contains everything)
    mins, maxs = bvh_lib.triangle_bounds(v0, v1, v2)
    np.testing.assert_allclose(tree.node_min[0], mins.min(0))
    np.testing.assert_allclose(tree.node_max[0], maxs.max(0))


def _scene_pair(n_tris=300, seed=0):
    """Same geometry twice: with and without a BVH."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = random_triangles(n_tris, rng)

    def make(bvh):
        b = SceneBuilder(background=(0.5, 0.6, 0.7), seed=1)
        m = b.lambertian(color=(0.5, 0.5, 0.5))
        for i in range(n_tris):
            b.triangle(v0[i], v1[i], v2[i], m)
        return b.build(bvh=bvh)

    return make(False), make(True)


def test_traversal_matches_linear():
    lin, acc = _scene_pair()
    assert lin.n_bvh_nodes == 0 and acc.n_bvh_nodes > 0

    rng = np.random.default_rng(42)
    B = 4096
    o = V3.from_array(jnp.asarray(rng.uniform(-8, 8, (B, 3)), jnp.float32))
    d = V3.from_array(jnp.asarray(rng.normal(size=(B, 3)), jnp.float32))
    time = jnp.zeros((B,))
    um = jnp.zeros((B, 0))

    t_lin, k_lin, i_lin = intersect.closest_hit(lin, o, d, time, um, 1e-3)
    t_acc, k_acc, i_acc = intersect.closest_hit(acc, o, d, time, um, 1e-3)

    np.testing.assert_array_equal(np.asarray(k_lin), np.asarray(k_acc))
    hit = np.asarray(k_lin) >= 0
    # identical winning triangle and t (same arithmetic on both paths)
    np.testing.assert_array_equal(np.asarray(i_lin)[hit], np.asarray(i_acc)[hit])
    # rtol: the two paths evaluate the same formula under different XLA
    # fusion orders; f32 rounding differs by a few ulp.
    np.testing.assert_allclose(np.asarray(t_lin)[hit], np.asarray(t_acc)[hit], rtol=1e-5)


def test_traversal_with_other_kinds_present():
    """BVH folds correctly against closer non-triangle hits."""
    rng = np.random.default_rng(3)
    v0, v1, v2 = random_triangles(200, rng)
    b = SceneBuilder(background=(0, 0, 0), seed=1)
    m = b.lambertian(color=(0.5, 0.5, 0.5))
    for i in range(200):
        b.triangle(v0[i], v1[i], v2[i], m)
    b.sphere((0, 0, 0), 2.0, m)  # big sphere overlapping the triangle cloud
    lin = b.build(bvh=False)
    acc = b.build(bvh=True)

    B = 2048
    o = V3.from_array(jnp.asarray(rng.uniform(-8, 8, (B, 3)), jnp.float32))
    d = V3.from_array(jnp.asarray(rng.normal(size=(B, 3)), jnp.float32))
    time = jnp.zeros((B,))
    um = jnp.zeros((B, 0))
    t_lin, k_lin, i_lin = intersect.closest_hit(lin, o, d, time, um, 1e-3)
    t_acc, k_acc, i_acc = intersect.closest_hit(acc, o, d, time, um, 1e-3)
    np.testing.assert_array_equal(np.asarray(k_lin), np.asarray(k_acc))
    np.testing.assert_array_equal(np.asarray(i_lin), np.asarray(i_acc))


def test_mesh_scene_uses_bvh(ref_assets):
    from another_raytracer.models import library
    scene, _ = library.mesh_scene()
    assert scene.n_bvh_nodes > 0
    assert scene.bvh_prim_order.shape[0] == scene.n_triangles
