"""The pytree dataclass helper (``deep_q_learning_tpu/struct.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from deep_q_learning_tpu import struct


@struct.dataclass
class _Base:
    x: jax.Array
    width: int = struct.field(pytree_node=False, default=3)


@struct.dataclass
class _Child(_Base):
    y: jax.Array = None


def test_static_fields_are_not_leaves():
    a = _Child(x=jnp.ones(2), width=5, y=jnp.zeros(3))
    leaves, treedef = jax.tree.flatten(a)
    assert len(leaves) == 2  # x and y; width lives in the treedef
    assert jax.tree.unflatten(treedef, leaves).width == 5
    # a different static value is a different tree (and jit cache key)
    assert treedef != jax.tree.structure(a.replace(width=6))
    assert len(jax.tree.leaves(_Child(x=jnp.ones(2)))) == 1  # y=None: no leaf


def test_replace_under_jit_and_frozen():
    @jax.jit
    def bump(a):
        return a.replace(x=a.x + a.width)

    out = bump(_Base(x=jnp.zeros(2), width=4))
    assert isinstance(out, _Base) and out.width == 4
    assert out.x.tolist() == [4.0, 4.0]
    with pytest.raises(dataclasses.FrozenInstanceError):
        out.x = jnp.ones(2)
