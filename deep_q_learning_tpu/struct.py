"""Frozen dataclasses that are JAX pytrees.

``@dataclass`` turns a class into a frozen :mod:`dataclasses` dataclass and
registers it with :func:`jax.tree_util.register_dataclass`.  Fields are pytree
leaves unless declared with ``field(pytree_node=False)``, which makes them
static metadata: part of the treedef (and so of a jit cache key), never
traced.  Instances gain ``.replace(**changes)``, a functional update that also
works on traced values inside ``jit``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import jax

T = TypeVar("T")


def field(pytree_node: bool = True, **kwargs: Any) -> Any:
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {}, pytree_node=pytree_node)
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self: T, **changes: Any) -> T:
    return dataclasses.replace(self, **changes)


def dataclass(cls: type[T]) -> type[T]:
    """Frozen dataclass registered as a pytree (see module docstring)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields if not f.metadata.get("pytree_node", True)],
    )
    cls.replace = _replace
    return cls
