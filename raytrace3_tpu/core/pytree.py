"""Frozen dataclasses registered as JAX pytrees.

``@pytree_dataclass`` makes a class a frozen dataclass whose fields are
pytree children, except those declared with :func:`static_field`, which
become hashable treedef metadata (they stay Python values under ``jit``).
Instances get a ``.replace(**changes)`` method.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field kept out of the pytree leaves (treedef metadata)."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (meta if f.metadata.get("static") else data).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
