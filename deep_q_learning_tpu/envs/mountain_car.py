"""MountainCar-v0 dynamics in pure JAX (published classic-control spec:
Moore 1990; force 0.001, gravity 0.0025, velocity clip ±0.07, position
[-1.2, 0.6], goal 0.5, reward -1 per step, 200-step limit, reset uniform in
[-0.6, -0.4]).  Widens the framework's pure-JAX env family beyond the two
BASELINE tasks; the reference could train on it through Gym, we through the
vectorized device path (or the host-compat loop)."""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from deep_q_learning_tpu import struct

from deep_q_learning_tpu.envs.base import Environment, EnvParams


@struct.dataclass
class MountainCarState:
    position: jax.Array
    velocity: jax.Array
    t: jax.Array


@struct.dataclass
class MountainCarParams(EnvParams):
    min_position: float = -1.2
    max_position: float = 0.6
    max_speed: float = 0.07
    goal_position: float = 0.5
    force: float = 0.001
    gravity: float = 0.0025
    max_steps_in_episode: int = struct.field(pytree_node=False, default=200)


class MountainCar(Environment[MountainCarState, MountainCarParams]):
    def default_params(self) -> MountainCarParams:
        return MountainCarParams()

    @property
    def num_actions(self) -> int:
        return 3  # push left / no push / push right

    def obs_shape(self, params) -> Tuple[int, ...]:
        return (2,)

    def reset_env(self, key, params):
        pos = jax.random.uniform(key, (), minval=-0.6, maxval=-0.4)
        state = MountainCarState(
            position=pos, velocity=jnp.float32(0.0), t=jnp.int32(0)
        )
        return self.get_obs(state, params), state

    batch_reset_cheap = True

    def reset_batch(self, key, n: int, params):
        pos = jax.random.uniform(key, (n,), minval=-0.6, maxval=-0.4)
        states = MountainCarState(
            position=pos,
            velocity=jnp.zeros((n,), jnp.float32),
            t=jnp.zeros((n,), jnp.int32),
        )
        obs = jax.vmap(self.get_obs, in_axes=(0, None))(states, params)
        return obs, states

    def get_obs(self, state, params):
        return jnp.stack([state.position, state.velocity]).astype(jnp.float32)

    def step_env(self, key, state, action, params):
        velocity = state.velocity + (action - 1) * params.force + jnp.cos(
            3.0 * state.position
        ) * (-params.gravity)
        velocity = jnp.clip(velocity, -params.max_speed, params.max_speed)
        position = jnp.clip(
            state.position + velocity, params.min_position, params.max_position
        )
        # inelastic left wall (published spec)
        velocity = jnp.where(
            (position <= params.min_position) & (velocity < 0), 0.0, velocity
        )
        new_state = MountainCarState(
            position=position, velocity=velocity, t=state.t + 1
        )
        terminated = position >= params.goal_position
        truncated = jnp.logical_and(
            new_state.t >= params.max_steps_in_episode, jnp.logical_not(terminated)
        )
        return (
            self.get_obs(new_state, params),
            new_state,
            jnp.float32(-1.0),
            terminated,
            truncated,
        )
