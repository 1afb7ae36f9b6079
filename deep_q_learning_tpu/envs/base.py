"""Functional environment API — the device-resident replacement for Gym's stateful envs.

The reference framework steps a single, host-side, stateful ``gym.Env``
(``/root/reference/General/QLearning/q_agent.py:177`` calls ``env.step`` once per
transition, crossing the host<->device boundary every step).  Here the
environment is a *pure function* over an explicit state pytree, so that

  * thousands of instances run in lockstep under ``jax.vmap``,
  * the whole actor loop compiles into a single XLA program (no host
    round-trips), and
  * env state arrays can be sharded over a device mesh on an ``"env"`` axis.

Design notes
------------
``Environment.step`` returns *separate* ``terminated`` and ``truncated``
flags.  The reference collapses both into one ``done``
(``q_agent.py:179-180`` forces ``done=True`` at the step cap and feeds it into
the TD target), which wrongly cuts the bootstrap at time-limit truncations.
We keep the distinction so the learner can bootstrap through truncations; a
ref-compat flag in the algorithm layer can deliberately restore the quirk.

Auto-reset happens inside :class:`VectorEnv.step` — a finished instance is
re-initialised *in the same compiled step* (``jnp.where`` select between the
stepped and freshly-reset state), which is what keeps the loop jittable.  The
pre-reset observation is still returned (``next_obs``) so replay stores the
true transition for bootstrapping.
"""

from __future__ import annotations

from typing import Any, Generic, Tuple, TypeVar

import jax
import jax.numpy as jnp
from deep_q_learning_tpu import struct

TEnvState = TypeVar("TEnvState")
TEnvParams = TypeVar("TEnvParams")


@struct.dataclass
class EnvParams:
    """Base class for static environment parameters (a pytree of leaves that
    may be traced, plus ``pytree_node=False`` fields for static config)."""

    max_steps_in_episode: int = struct.field(pytree_node=False, default=1000)


class Environment(Generic[TEnvState, TEnvParams]):
    """Abstract pure-functional environment.

    Subclasses implement ``reset_env`` / ``step_env`` / ``get_obs`` /
    ``is_terminal`` as pure jax functions over a single (unbatched) instance.
    Batch semantics come from ``jax.vmap`` in :class:`VectorEnv` — never from
    manual batching inside the dynamics.
    """

    # ------------------------------------------------------------------ api
    def default_params(self) -> TEnvParams:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

    @property
    def num_actions(self) -> int:
        raise NotImplementedError

    def obs_shape(self, params: TEnvParams) -> Tuple[int, ...]:
        raise NotImplementedError

    def reset_env(self, key: jax.Array, params: TEnvParams) -> Tuple[jax.Array, TEnvState]:
        """Fresh episode. Returns (obs, state)."""
        raise NotImplementedError

    # Whether ``reset_batch`` is cheap enough to run EVERY frame for the
    # auto-reset path (a bulk-RNG draw, no physics).  Classic-control envs
    # override this with True; envs whose reset runs real physics (the
    # lander: terrain generation + one solver frame) keep the per-superstep
    # pool instead (see VectorEnv.step / algos.superstep).
    batch_reset_cheap: bool = False

    def reset_batch(self, key: jax.Array, n: int, params: TEnvParams):
        """``n`` fresh episodes at once. Returns batched (obs, states).

        Default: vmap of ``reset_env`` over per-instance key splits.  Envs
        with trivial reset distributions override this with ONE bulk RNG
        draw — per-env threefry key hashing is the dominant cost of the
        vmapped form, and a bulk draw makes per-frame auto-reset affordable
        (ADVICE r3: a per-superstep pool replayed identical start states
        when episodes are shorter than the superstep window)."""
        keys = jax.random.split(key, n)
        return jax.vmap(self.reset_env, in_axes=(0, None))(keys, params)

    def get_obs(self, state: TEnvState, params: TEnvParams) -> jax.Array:
        """Observation of ``state`` (pure; used to recover s_t without storing it)."""
        raise NotImplementedError

    def step_env(
        self, key: jax.Array, state: TEnvState, action: jax.Array, params: TEnvParams
    ) -> Tuple[jax.Array, TEnvState, jax.Array, jax.Array, jax.Array]:
        """One transition. Returns (obs, state, reward, terminated, truncated)."""
        raise NotImplementedError

    # ------------------------------------------------------- jittable edges
    def reset(self, key: jax.Array, params: TEnvParams) -> Tuple[jax.Array, TEnvState]:
        return self.reset_env(key, params)

    def step(
        self, key: jax.Array, state: TEnvState, action: jax.Array, params: TEnvParams
    ) -> Tuple[jax.Array, TEnvState, jax.Array, jax.Array, jax.Array]:
        return self.step_env(key, state, action, params)


@struct.dataclass
class Transition:
    """One (batched) environment transition, the replay storage record.

    ``next_obs`` is the TRUE successor observation (pre-auto-reset), so TD
    targets bootstrap from the right state.  ``terminated`` cuts the bootstrap;
    ``truncated`` only ends the episode for accounting.  The reference stores a
    single ``done`` covering both (``q_agent.py:182``)."""

    obs: jax.Array  # (N, *obs_shape)
    action: jax.Array  # (N,) int32
    reward: jax.Array  # (N,) float32
    next_obs: jax.Array  # (N, *obs_shape)
    terminated: jax.Array  # (N,) bool
    truncated: jax.Array  # (N,) bool


class VectorEnv:
    """``num_envs`` lockstep instances of a pure env, with in-graph auto-reset.

    All methods are pure; states/observations carry a leading ``(N, ...)`` axis
    that is the framework's data-parallel ("env") sharding axis.
    """

    def __init__(self, env: Environment, num_envs: int):
        self.env = env
        self.num_envs = num_envs

    @property
    def num_actions(self) -> int:
        return self.env.num_actions

    def obs_shape(self, params) -> Tuple[int, ...]:
        return self.env.obs_shape(params)

    def reset(self, key: jax.Array, params) -> Tuple[jax.Array, Any]:
        keys = jax.random.split(key, self.num_envs)
        return jax.vmap(self.env.reset, in_axes=(0, None))(keys, params)

    def fresh_pool(self, key: jax.Array, params):
        """Per-env reset pool for ``step(..., fresh=...)`` — computed once
        per superstep call instead of per frame (for envs whose reset runs
        real physics; cheap-reset envs skip the pool entirely, see
        ``Environment.batch_reset_cheap``)."""
        keys = jax.random.split(key, self.num_envs)
        return jax.vmap(self.env.reset, in_axes=(0, None))(keys, params)

    def step(
        self, key: jax.Array, states: Any, actions: jax.Array, params,
        prev_obs: Any = None, fresh: Any = None,
    ) -> Tuple[jax.Array, Any, Transition]:
        """Step all instances; auto-reset finished ones.

        Returns ``(obs_after_autoreset, states_after_autoreset, transition)``
        where ``transition`` holds the pre-reset ``next_obs``/flags for replay.

        ``prev_obs``: the current observations, if the caller already holds
        them (the superstep does) — skips recomputing get_obs per frame.

        ``fresh``: optional precomputed reset pool (``fresh_pool``'s
        ``(fresh_obs, fresh_states)``), consulted by entry: env ``i`` resets
        into pool entry ``i``.  When None, fresh states come from
        ``Environment.reset_batch`` — drawn EVERY frame, so consecutive
        resets of one env always differ (the exact semantics; affordable
        when ``batch_reset_cheap``).  Pool caveat: an env finishing twice
        within one pool lifetime replays its pool entry; acceptable only
        for envs whose episodes are long relative to the pool lifetime
        and/or whose dynamics noise decorrelates repeated starts (the
        lander's per-frame engine dispersion does; see algos.superstep).
        """
        step_key, reset_key = jax.random.split(key)
        step_keys = jax.random.split(step_key, self.num_envs)

        if prev_obs is None:
            prev_obs = jax.vmap(self.env.get_obs, in_axes=(0, None))(states, params)
        next_obs, next_states, reward, terminated, truncated = jax.vmap(
            self.env.step, in_axes=(0, 0, 0, None)
        )(step_keys, states, actions, params)

        done = jnp.logical_or(terminated, truncated)
        if fresh is None:
            fresh_obs, fresh_states = self.env.reset_batch(
                reset_key, self.num_envs, params
            )
        else:
            fresh_obs, fresh_states = fresh

        def _select(fresh, stepped):
            mask = done.reshape((self.num_envs,) + (1,) * (stepped.ndim - 1))
            return jnp.where(mask, fresh, stepped)

        out_states = jax.tree.map(_select, fresh_states, next_states)
        out_obs = _select(fresh_obs, next_obs)

        transition = Transition(
            obs=prev_obs,
            action=actions,
            reward=reward,
            next_obs=next_obs,
            terminated=terminated,
            truncated=truncated,
        )
        return out_obs, out_states, transition
