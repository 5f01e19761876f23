"""Host-side BVH construction over triangle bounds.

The reference builds a binary BVH of shared_ptr nodes with a *random* split
axis and median sort (bvh.cpp:3-42).  Deliberate divergence (PARITY.md #6):
the split axis here is the widest centroid extent — deterministic and
measurably better — with the same median split.  The tree is emitted as flat
arrays in depth-first order with *escape indices* for stackless traversal on
device (ops/bvh.py): a node either advances to ``i+1`` (box hit) or jumps to
``escape[i]`` (box missed / subtree done); leaves reference a contiguous run
of reordered primitive ids.

The device traversal (ops/bvh.traverse_packed) reads the tree through the
packed row formats built here by ``pack_*``:

Node rows ([M, 8] f32):
  0..2 box min, 3..5 box max, 6 escape index, 7 leaf_meta = first*64 + count
  (exact in f32 for first < 2^17; internal nodes have count = 0).

Primitive rows ([N + pad, 16] f32, pre-reordered into leaf order so a leaf
is one contiguous run):

``'planar'`` — triangles, including the two world-space triangles each
accelerated transformed axis-rect is split into for the *winner search*
(the hit record is recomputed from the original rect parameters,
ops/intersect.py): 0..2 v0, 3..5 v1, 6..8 v2, 9 code.

``'sphere'`` — static & moving spheres with transforms baked into world
centers (a rigid transform maps a sphere to a sphere; lerp commutes with the
affine map, so t values are identical to the object-space test):
0..2 c0 (world center at t0), 3..5 c1-c0, 6 t0, 7 1/(t1-t0), 8 r, 9 code.

``'rect'`` — IDENTITY-transform axis-aligned rects tested natively (plane
solve + inclusive 2D bound check, the exact aarect.cpp semantics of the
[B, N] sweep): 0 axis (0/1/2 as f32), 1 k, 2 lo_u, 3 lo_v, 4 hi_u, 5 hi_v,
9 code.

``code`` encodes (within-kind id, primitive kind) as ``id * 4 + kind`` using
the scene kind constants — exact in f32 for id < 2^22.

Traversal correctness is exhaustively tested against the linear
intersect-everything path (tests/test_bvh.py, tests/test_accel.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

LEAF_SIZE = 8


@dataclasses.dataclass
class FlatBVH:
    node_min: np.ndarray  # [M,3]
    node_max: np.ndarray  # [M,3]
    escape: np.ndarray  # [M] int32: next node index when this box is missed
    leaf_first: np.ndarray  # [M] int32: first index into prim_order (leaves)
    leaf_count: np.ndarray  # [M] int32: 0 for internal nodes
    prim_order: np.ndarray  # [N] int32: primitive ids in leaf-contiguous order

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


def build(mins: np.ndarray, maxs: np.ndarray, leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """Build from per-primitive AABBs ([N,3] mins/maxs, float64)."""
    n = mins.shape[0]
    assert n > 0
    centroids = 0.5 * (mins + maxs)

    nodes_min, nodes_max, escape, leaf_first, leaf_count = [], [], [], [], []
    prim_order = []

    def emit(ids) -> int:
        """Emit subtree for primitive ids; returns node index."""
        idx = len(nodes_min)
        lo = mins[ids].min(axis=0)
        hi = maxs[ids].max(axis=0)
        nodes_min.append(lo)
        nodes_max.append(hi)
        escape.append(-1)  # patched after subtree emission
        if len(ids) <= leaf_size:
            leaf_first.append(len(prim_order))
            leaf_count.append(len(ids))
            prim_order.extend(ids.tolist())
        else:
            leaf_first.append(0)
            leaf_count.append(0)
            c = centroids[ids]
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            order = np.argsort(c[:, axis], kind="stable")
            # Median split rounded to a leaf_size multiple: every leaf except
            # possibly the last comes out FULL, so the traversal's unrolled
            # leaf loop (leaf_size tests, masked by count) wastes no lanes on
            # partial leaves, and the tree has ~leaf_size/avg fewer nodes
            # than a plain median split.
            half = max(leaf_size, (len(ids) // 2 // leaf_size) * leaf_size)
            emit(ids[order[:half]])
            emit(ids[order[half:]])
        escape[idx] = len(nodes_min)  # one past the subtree in DFS order
        return idx

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * int(np.ceil(np.log2(max(n, 2)))) + 10000))
    try:
        emit(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)

    return FlatBVH(
        node_min=np.asarray(nodes_min),
        node_max=np.asarray(nodes_max),
        escape=np.asarray(escape, np.int32),
        leaf_first=np.asarray(leaf_first, np.int32),
        leaf_count=np.asarray(leaf_count, np.int32),
        prim_order=np.asarray(prim_order, np.int32),
    )


# Flat-primitive AABB padding.  The slab test is strict (tn < tf), so a
# zero-extent axis (an axis-aligned rect/triangle) would make its own box
# unhittable; the reference pads rect boxes the same way (aarect.h k±0.0001).
FLAT_PAD = 1e-4


def pad_flat(mins, maxs):
    thin = (maxs - mins) < FLAT_PAD
    return np.where(thin, mins - FLAT_PAD, mins), np.where(thin, maxs + FLAT_PAD, maxs)


def triangle_bounds(v0, v1, v2):
    """Per-triangle AABBs (triangle.h:90-95), padded on flat axes."""
    mins = np.minimum(np.minimum(v0, v1), v2)
    maxs = np.maximum(np.maximum(v0, v1), v2)
    return pad_flat(mins, maxs)


def rect_bounds(axis, k, lo, hi):
    """Per-axis-rect AABBs (aarect.h:16-21 semantics: flat on `axis` at k,
    spanning lo/hi on the two free axes in ascending order), padded flat."""
    axis = np.asarray(axis, np.int64)
    n = axis.shape[0]
    mins = np.zeros((n, 3))
    maxs = np.zeros((n, 3))
    au = np.where(axis == 0, 1, 0)
    av = np.where(axis == 2, 1, 2)
    rng = np.arange(n)
    mins[rng, axis] = maxs[rng, axis] = np.asarray(k, np.float64)
    mins[rng, au] = np.asarray(lo, np.float64)[:, 0]
    mins[rng, av] = np.asarray(lo, np.float64)[:, 1]
    maxs[rng, au] = np.asarray(hi, np.float64)[:, 0]
    maxs[rng, av] = np.asarray(hi, np.float64)[:, 1]
    return pad_flat(mins, maxs)


def sphere_bounds(c0, c1, r, t0=None, t1=None, exposure=(0.0, 1.0)):
    """Per-sphere AABBs over the camera exposure window.

    The sphere tests lerp the center with an UNCLAMPED time fraction
    (moving_sphere.h:29-31 divides, never clamps), so a ray time outside the
    sphere's own [t0, t1] lands on the extrapolated segment.  Boxing only the
    [t0, t1] hull could BVH-cull such a hit; the reference avoids this by
    boxing at the *camera's* time0/time1 (moving_sphere.h:60-74 is called
    with the exposure interval, bvh.cpp passes engine times).  Here centers
    are extrapolated to both exposure endpoints (main.cpp:35 shutter [0,1])
    before taking the hull; identical to the plain hull whenever the sphere's
    interval equals the exposure (all canonical scenes).  |r| handles the
    reference's negative-radius hollow dielectrics."""
    c0 = np.asarray(c0, np.float64)
    c1 = np.asarray(c1, np.float64)
    if t0 is not None:
        t0 = np.asarray(t0, np.float64)[:, None]
        t1 = np.asarray(t1, np.float64)[:, None]
        dt = np.where(t1 != t0, t1 - t0, 1.0)
        ca = c0 + (exposure[0] - t0) / dt * (c1 - c0)
        cb = c0 + (exposure[1] - t0) / dt * (c1 - c0)
        c0, c1 = ca, cb
    r = np.abs(np.asarray(r, np.float64))[:, None]
    mins = np.minimum(c0, c1) - r
    maxs = np.maximum(c0, c1) + r
    return mins, maxs


# --------------------------------------------------------------------------
# Packed row formats for the device traversal (see module docstring)
# --------------------------------------------------------------------------

META_SCALE = 64  # leaf_meta = first * META_SCALE + count; count < META_SCALE
ROW_COLS = 16


def pack_nodes(tree: FlatBVH) -> np.ndarray:
    """Host-side node packing -> [M,8] f32."""
    m = tree.num_nodes
    nodes = np.zeros((m, 8), np.float32)
    nodes[:, 0:3] = tree.node_min
    nodes[:, 3:6] = tree.node_max
    nodes[:, 6] = tree.escape
    assert tree.leaf_count.max() < META_SCALE
    nodes[:, 7] = tree.leaf_first * META_SCALE + tree.leaf_count
    return nodes


def _leaf_rows(tree: FlatBVH) -> np.ndarray:
    order = tree.prim_order
    pad = max(int(tree.leaf_count.max()), 1)
    return np.zeros((order.shape[0] + pad, ROW_COLS), np.float32)


def pack_planar(tree: FlatBVH, v0, v1, v2, codes) -> tuple:
    """(nodes [M,8], rows [N+pad,16]) for the 'planar' format.

    ``codes``: [N] int array, ``id * 4 + kind`` per primitive in build order.
    Rows are reordered into leaf order (tree.prim_order); trailing pad rows
    are all-zero (degenerate normal -> never hit)."""
    codes = np.asarray(codes, np.int64)
    assert codes.max(initial=0) < (1 << 24), "code must be exact in f32"
    order = tree.prim_order
    n = order.shape[0]
    rows = _leaf_rows(tree)
    rows[:n, 0:3] = np.asarray(v0)[order]
    rows[:n, 3:6] = np.asarray(v1)[order]
    rows[:n, 6:9] = np.asarray(v2)[order]
    rows[:n, 9] = codes[order]
    return pack_nodes(tree), rows


def pack_rects(tree: FlatBVH, axis, k, lo, hi, codes) -> tuple:
    """(nodes [M,8], rows [N+pad,16]) for the 'rect' format (identity-
    transform axis rects only).  Pad rows get inverted u-bounds
    (lo_u=1 > hi_u=0) so they can never test inside."""
    codes = np.asarray(codes, np.int64)
    assert codes.max(initial=0) < (1 << 24)
    order = tree.prim_order
    n = order.shape[0]
    rows = _leaf_rows(tree)
    rows[:n, 0] = np.asarray(axis, np.float64)[order]
    rows[:n, 1] = np.asarray(k, np.float64)[order]
    rows[:n, 2] = np.asarray(lo, np.float64)[order, 0]
    rows[:n, 3] = np.asarray(lo, np.float64)[order, 1]
    rows[:n, 4] = np.asarray(hi, np.float64)[order, 0]
    rows[:n, 5] = np.asarray(hi, np.float64)[order, 1]
    rows[:n, 9] = codes[order]
    rows[n:, 2] = 1.0  # lo_u > hi_u: unhittable pad
    return pack_nodes(tree), rows


def pack_spheres(tree: FlatBVH, c0_w, c1_w, t0, t1, r) -> tuple:
    """(nodes [M,8], rows [N+pad,16]) for the 'sphere' format.  Centers are
    WORLD-space (transforms baked); zero pad rows are never hit (r = 0 gives
    disc <= 0 by Cauchy-Schwarz)."""
    from another_raytracer.models.scene import PRIM_SPHERE

    order = tree.prim_order
    n = order.shape[0]
    assert n < (1 << 22)
    rows = _leaf_rows(tree)
    c0_w = np.asarray(c0_w, np.float64)[order]
    c1_w = np.asarray(c1_w, np.float64)[order]
    t0 = np.asarray(t0, np.float64)[order]
    t1 = np.asarray(t1, np.float64)[order]
    rows[:n, 0:3] = c0_w
    rows[:n, 3:6] = c1_w - c0_w
    rows[:n, 6] = t0
    dt = t1 - t0
    rows[:n, 7] = np.where(dt != 0.0, 1.0 / np.where(dt != 0.0, dt, 1.0), 0.0)
    rows[:n, 8] = np.asarray(r, np.float64)[order]
    rows[:n, 9] = order * 4 + PRIM_SPHERE
    return pack_nodes(tree), rows
