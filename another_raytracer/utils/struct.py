"""Frozen dataclasses registered as JAX pytrees.

Fields are pytree leaves unless declared with :func:`static_field`, which
makes them hashable metadata: part of the tree structure, so they key jit
caches and stay Python values under tracing.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(default):
    """A non-pytree (static metadata) field with a default."""
    return dataclasses.field(default=default, metadata={"static": True})


def dataclass(cls):
    """Make ``cls`` a frozen dataclass pytree with a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    cls.replace = replace
    return cls
