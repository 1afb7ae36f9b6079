"""CartPole-v1 dynamics in pure JAX.

Re-implementation of the classic cart-pole balancing task from its published
specification (Barto, Sutton & Anderson 1983; the `CartPole-v1` config:
Euler integration, tau=0.02, reward 1.0 per step, 500-step limit,
termination at |x|>2.4 or |theta|>12 deg, reset uniform in (-0.05, 0.05)).

The reference repo has no env physics of its own — it imports Gym
(``/root/reference/General/QLearning/q_agent.py:177``).  This module replaces
that host-side dependency with jittable dynamics so the whole actor loop
compiles onto the accelerator.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from deep_q_learning_tpu import struct

from deep_q_learning_tpu.envs.base import Environment, EnvParams


@struct.dataclass
class CartPoleState:
    x: jax.Array
    x_dot: jax.Array
    theta: jax.Array
    theta_dot: jax.Array
    t: jax.Array  # step counter, int32


@struct.dataclass
class CartPoleParams(EnvParams):
    gravity: float = 9.8
    masscart: float = 1.0
    masspole: float = 0.1
    length: float = 0.5  # half the pole's length
    force_mag: float = 10.0
    tau: float = 0.02
    theta_threshold: float = 12 * 2 * jnp.pi / 360
    x_threshold: float = 2.4
    max_steps_in_episode: int = struct.field(pytree_node=False, default=500)


class CartPole(Environment[CartPoleState, CartPoleParams]):
    """CartPole-v1 as a pure function; Euler integrator, float32."""

    def default_params(self) -> CartPoleParams:
        return CartPoleParams()

    @property
    def num_actions(self) -> int:
        return 2

    def obs_shape(self, params: CartPoleParams) -> Tuple[int, ...]:
        return (4,)

    def reset_env(self, key: jax.Array, params: CartPoleParams):
        init = jax.random.uniform(key, (4,), minval=-0.05, maxval=0.05)
        state = CartPoleState(
            x=init[0],
            x_dot=init[1],
            theta=init[2],
            theta_dot=init[3],
            t=jnp.int32(0),
        )
        return self.get_obs(state, params), state

    # trivial reset distribution: one bulk draw replaces n key-splits, so
    # per-frame auto-reset costs ~one uniform op (Environment.reset_batch)
    batch_reset_cheap = True

    def reset_batch(self, key: jax.Array, n: int, params: CartPoleParams):
        init = jax.random.uniform(key, (n, 4), minval=-0.05, maxval=0.05)
        states = CartPoleState(
            x=init[:, 0],
            x_dot=init[:, 1],
            theta=init[:, 2],
            theta_dot=init[:, 3],
            t=jnp.zeros((n,), jnp.int32),
        )
        obs = jax.vmap(self.get_obs, in_axes=(0, None))(states, params)
        return obs, states

    def get_obs(self, state: CartPoleState, params: CartPoleParams) -> jax.Array:
        return jnp.stack(
            [state.x, state.x_dot, state.theta, state.theta_dot]
        ).astype(jnp.float32)

    def step_env(self, key, state: CartPoleState, action, params: CartPoleParams):
        force = jnp.where(action == 1, params.force_mag, -params.force_mag)
        costheta = jnp.cos(state.theta)
        sintheta = jnp.sin(state.theta)

        total_mass = params.masscart + params.masspole
        polemass_length = params.masspole * params.length

        temp = (
            force + polemass_length * state.theta_dot**2 * sintheta
        ) / total_mass
        thetaacc = (params.gravity * sintheta - costheta * temp) / (
            params.length
            * (4.0 / 3.0 - params.masspole * costheta**2 / total_mass)
        )
        xacc = temp - polemass_length * thetaacc * costheta / total_mass

        # Euler ("kinematics_integrator == 'euler'" in the public spec)
        x = state.x + params.tau * state.x_dot
        x_dot = state.x_dot + params.tau * xacc
        theta = state.theta + params.tau * state.theta_dot
        theta_dot = state.theta_dot + params.tau * thetaacc

        new_state = CartPoleState(
            x=x, x_dot=x_dot, theta=theta, theta_dot=theta_dot, t=state.t + 1
        )

        terminated = jnp.logical_or(
            jnp.abs(x) > params.x_threshold,
            jnp.abs(theta) > params.theta_threshold,
        )
        truncated = jnp.logical_and(
            new_state.t >= params.max_steps_in_episode, jnp.logical_not(terminated)
        )
        reward = jnp.float32(1.0)
        return (
            self.get_obs(new_state, params),
            new_state,
            reward,
            terminated,
            truncated,
        )
