"""Frozen dataclasses registered as JAX pytrees.

``dataclass`` turns a class into a frozen stdlib dataclass whose fields are
pytree leaves, except those declared with ``field(pytree_node=False)``: those
are static metadata (part of the treedef, so they key jit caches and must be
hashable). Instances get a ``replace(**changes)`` method.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    return dataclasses.field(metadata={"static": not pytree_node}, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = dataclasses.replace
    return cls
