"""Q-value networks in plain JAX.

Covers the reference's model family (``/root/reference/LunarLander/dddqn.py:11-34``:
MLP trunk Linear(32)->relu->Linear(64)->relu with a dueling value/advantage
head, ``Q = V + A - mean(A)``) as one configurable module, plus a plain
(non-dueling) head for vanilla DQN.

Parameters are a nested dict
``{"params": {"trunk_i" | "value" | "advantage" | "q": {"kernel", "bias"}}}``
with ``kernel`` shaped ``(in, out)``.  Kernels are LeCun-normal (truncated
normal, variance ``1/fan_in``) and biases zero.  Each layer's key is
``fold_in(key, sha1("<layer name>", 1))``, the derivation Flax's
``linen.Dense`` used, so a seed gives the same initial weights it gave when
this network was a Flax module (``utils/checkpoint.py``'s reference-pickle
converter and the solve-validated recipes rely on the tree and the init).

* ``compute_dtype=bfloat16`` runs the trunk's matmuls in bf16 while keeping
  parameters and the Q output in float32 (TD targets want f32 accuracy).
* ``return_features`` mirrors the reference's penultimate-feature output
  (``dddqn.py:24,32-33``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

_kernel_init = jax.nn.initializers.lecun_normal()


def _layer_key(key: jax.Array, name: str) -> jax.Array:
    """Key of the first parameter drawn in layer ``name`` (Flax's scheme)."""
    digest = hashlib.sha1(name.encode("utf-8") + (1).to_bytes(1, "big")).digest()
    return jax.random.fold_in(key, jnp.uint32(int.from_bytes(digest[:4], "big")))


def _dense(p: dict, x: jax.Array, dtype) -> jax.Array:
    x = x.astype(dtype)
    return x @ p["kernel"].astype(dtype) + p["bias"].astype(dtype)


@dataclasses.dataclass(frozen=True)
class QNetwork:
    """MLP Q-network with optional dueling head.

    Attributes:
      num_actions: size of the discrete action space.
      hidden: trunk layer widths (reference: ``(32, 64)``, dddqn.py:19-20).
      dueling: if True, ``Q = V + A - mean_a(A)`` (dddqn.py:29-31); else a
        single linear head.
      compute_dtype: dtype for trunk activations/matmuls.
    """

    num_actions: int
    hidden: Sequence[int] = (256, 256)
    dueling: bool = True
    compute_dtype: Any = jnp.float32

    def _heads(self) -> Tuple[Tuple[str, int], ...]:
        if self.dueling:
            return (("value", 1), ("advantage", self.num_actions))
        return (("q", self.num_actions),)

    def init(self, key: jax.Array, x: jax.Array) -> dict:
        """Parameters for inputs shaped like ``x`` (only its last axis counts)."""
        params = {}
        fan_in = x.shape[-1]
        for i, width in enumerate(self.hidden):
            name = f"trunk_{i}"
            params[name] = {
                "kernel": _kernel_init(_layer_key(key, name), (fan_in, width), jnp.float32),
                "bias": jnp.zeros((width,), jnp.float32),
            }
            fan_in = width
        for name, width in self._heads():
            params[name] = {
                "kernel": _kernel_init(_layer_key(key, name), (fan_in, width), jnp.float32),
                "bias": jnp.zeros((width,), jnp.float32),
            }
        return {"params": params}

    def apply(
        self, params: dict, x: jax.Array, return_features: bool = False
    ) -> Union[jax.Array, Tuple[jax.Array, jax.Array]]:
        p = params["params"]
        x = x.astype(self.compute_dtype)
        for i in range(len(self.hidden)):
            x = jax.nn.relu(_dense(p[f"trunk_{i}"], x, self.compute_dtype))
        features = x
        if self.dueling:
            val = _dense(p["value"], x, jnp.float32)
            adv = _dense(p["advantage"], x, jnp.float32)
            q = val + adv - jnp.mean(adv, axis=-1, keepdims=True)
        else:
            q = _dense(p["q"], x, jnp.float32)
        if return_features:
            return q, features.astype(jnp.float32)
        return q
