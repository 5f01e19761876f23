"""Small-table lookups as one-hot matmuls.

A path tracer does dozens of table lookups per ray per bounce
(material/texture/transform/primitive tables).  For a small table they are
written as dense algebra instead of gathers:
    out[b] = sum_k onehot(idx[b], k) * table[k]
i.e. a [B,K] one-hot against a [K,C] column block — one small matmul
replaces C gathers, and XLA CSEs the shared one-hot across every lookup
keyed on the same index vector.  This formulation came from an accelerator
whose gathers ran as scalar loops; whether direct gathers are faster on the
GPU is an open question (ROADMAP).

``Lookup`` batches all columns of one index into a single dot; use
``plan()`` for a reusable one-hot.  Above ``MAX_ONEHOT_K`` (mesh-sized
tables) it falls back to real gathers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

MAX_ONEHOT_K = 512

# Dense-path matmul strategy (trace-time switch):
# True  -> manual 3-term bf16 table split: the one-hot is EXACT in bf16, so
#          splitting only the table (Dekker-style hi/mid/lo, 8 significand
#          bits each = all 24 f32 bits) reconstructs f32 exactly with THREE
#          native bf16 matmul passes;
# False -> precision=HIGHEST, which splits BOTH operands (6 passes) because
#          XLA cannot know the one-hot side is exactly representable.
# Both are bit-exact for f32 tables and ints < 2^24 — except f32 SUBNORMAL
# table values (|x| < 1.18e-38), which the split flushes to 0; no scene
# table holds subnormals (colors, coordinates, ids, unit vectors).
#
# Default False: HIGHEST measured faster where the two were compared; the
# split's extra elementwise table prep outweighed the saved passes.
SPLIT_TABLE = False


class Lookup:
    """Batched lookups ``table_col[idx]`` sharing one one-hot matrix.

    idx: [B] integer array (assumed already clipped to [0, K)).
    K:   static table length.
    """

    def __init__(self, idx, K: int):
        self.idx = idx
        self.K = int(K)
        self.dense = 0 < self.K <= MAX_ONEHOT_K
        if self.dense:
            iota = jnp.arange(self.K, dtype=idx.dtype)
            self.onehot = (idx[:, None] == iota[None, :]).astype(jnp.float32)

    def __call__(self, *columns):
        """columns: 1D [K] arrays (any dtype).  Returns the gathered [B]
        arrays in the same order and dtypes (ints must be < 2^24)."""
        if not self.dense:
            return tuple(c[self.idx] for c in columns)
        stacked = jnp.stack(
            [c.astype(jnp.float32) for c in columns], axis=1
        )  # [K, C]
        # A single-pass bf16 (or TF32) matmul would round table values
        # (e.g. 555 -> 556), silently changing renders; both paths below
        # reconstruct f32 exactly (see SPLIT_TABLE).
        if SPLIT_TABLE:
            oh = self.onehot.astype(jnp.bfloat16)  # 0/1: exact
            hi = stacked.astype(jnp.bfloat16)
            r1 = stacked - hi.astype(jnp.float32)  # exact (Sterbenz)
            mid = r1.astype(jnp.bfloat16)
            lo = (r1 - mid.astype(jnp.float32)).astype(jnp.bfloat16)  # exact

            def p(tbl):
                return jnp.dot(oh, tbl, preferred_element_type=jnp.float32)

            # hi+mid is <= 16 significant bits over a 16-bit span, so the
            # f32 sums re-associate exactly; + lo completes all 24 bits.
            out = (p(hi) + p(mid)) + p(lo)
        else:
            out = jnp.dot(
                self.onehot, stacked, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
        return tuple(
            out[:, i].astype(c.dtype) for i, c in enumerate(columns)
        )

    def v3(self, arr2d):
        """[K,3] table -> V3 of gathered [B] columns."""
        from another_raytracer.ops.vec3 import V3

        x, y, z = self(arr2d[:, 0], arr2d[:, 1], arr2d[:, 2])
        return V3(x, y, z)
