"""Frozen dataclasses that are JAX pytrees.

``dataclass`` registers a frozen dataclass with
``jax.tree_util.register_dataclass``: fields are children unless declared
with ``static_field()``, which makes them hashable treedef metadata (so the
object stays a valid ``jit`` argument).  ``.replace(**changes)`` returns a
copy with some fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A field kept in the treedef, not traced."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
    cls.replace = dataclasses.replace
    return cls
