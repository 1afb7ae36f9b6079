"""Acrobot-v1 dynamics in pure JAX (published spec: Sutton 1996 two-link
underactuated pendulum; RK4 integration of the book's equations, torque
in {-1, 0, +1} on the second joint, reward -1 per step until the tip
reaches -cos(θ1) - cos(θ2+θ1) > 1, 500-step limit, reset uniform ±0.1)."""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from deep_q_learning_tpu import struct

from deep_q_learning_tpu.envs.base import Environment, EnvParams

# published physical constants (link masses/lengths = 1, com at 0.5, I = 1)
L1 = 1.0
M1 = M2 = 1.0
LC1 = LC2 = 0.5
I1 = I2 = 1.0
G = 9.8
DT = 0.2
MAX_VEL_1 = 4.0 * jnp.pi
MAX_VEL_2 = 9.0 * jnp.pi


@struct.dataclass
class AcrobotState:
    theta1: jax.Array
    theta2: jax.Array
    dtheta1: jax.Array
    dtheta2: jax.Array
    t: jax.Array


@struct.dataclass
class AcrobotParams(EnvParams):
    max_steps_in_episode: int = struct.field(pytree_node=False, default=500)


def _dynamics(s: jax.Array, torque: jax.Array) -> jax.Array:
    """d/dt of [θ1, θ2, ω1, ω2] — the book's equations of motion."""
    theta1, theta2, dtheta1, dtheta2 = s[0], s[1], s[2], s[3]
    d1 = (
        M1 * LC1**2
        + M2 * (L1**2 + LC2**2 + 2 * L1 * LC2 * jnp.cos(theta2))
        + I1
        + I2
    )
    d2 = M2 * (LC2**2 + L1 * LC2 * jnp.cos(theta2)) + I2
    phi2 = M2 * LC2 * G * jnp.cos(theta1 + theta2 - jnp.pi / 2.0)
    phi1 = (
        -M2 * L1 * LC2 * dtheta2**2 * jnp.sin(theta2)
        - 2 * M2 * L1 * LC2 * dtheta2 * dtheta1 * jnp.sin(theta2)
        + (M1 * LC1 + M2 * L1) * G * jnp.cos(theta1 - jnp.pi / 2.0)
        + phi2
    )
    # "book" variant of the accelerations (the published env default)
    ddtheta2 = (
        torque + d2 / d1 * phi1 - M2 * L1 * LC2 * dtheta1**2 * jnp.sin(theta2) - phi2
    ) / (M2 * LC2**2 + I2 - d2**2 / d1)
    ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
    return jnp.stack([dtheta1, dtheta2, ddtheta1, ddtheta2])


def _rk4_step(s: jax.Array, torque: jax.Array, dt: float) -> jax.Array:
    k1 = _dynamics(s, torque)
    k2 = _dynamics(s + dt / 2 * k1, torque)
    k3 = _dynamics(s + dt / 2 * k2, torque)
    k4 = _dynamics(s + dt * k3, torque)
    return s + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def _wrap(x, low, high):
    return low + jnp.mod(x - low, high - low)


class Acrobot(Environment[AcrobotState, AcrobotParams]):
    def default_params(self) -> AcrobotParams:
        return AcrobotParams()

    @property
    def num_actions(self) -> int:
        return 3  # torque -1 / 0 / +1

    def obs_shape(self, params) -> Tuple[int, ...]:
        return (6,)

    def reset_env(self, key, params):
        init = jax.random.uniform(key, (4,), minval=-0.1, maxval=0.1)
        state = AcrobotState(
            theta1=init[0], theta2=init[1], dtheta1=init[2], dtheta2=init[3],
            t=jnp.int32(0),
        )
        return self.get_obs(state, params), state

    batch_reset_cheap = True

    def reset_batch(self, key, n: int, params):
        init = jax.random.uniform(key, (n, 4), minval=-0.1, maxval=0.1)
        states = AcrobotState(
            theta1=init[:, 0], theta2=init[:, 1],
            dtheta1=init[:, 2], dtheta2=init[:, 3],
            t=jnp.zeros((n,), jnp.int32),
        )
        obs = jax.vmap(self.get_obs, in_axes=(0, None))(states, params)
        return obs, states

    def get_obs(self, state, params):
        return jnp.stack(
            [
                jnp.cos(state.theta1),
                jnp.sin(state.theta1),
                jnp.cos(state.theta2),
                jnp.sin(state.theta2),
                state.dtheta1,
                state.dtheta2,
            ]
        ).astype(jnp.float32)

    def step_env(self, key, state, action, params):
        torque = (action - 1).astype(jnp.float32)
        s = jnp.stack([state.theta1, state.theta2, state.dtheta1, state.dtheta2])
        ns = _rk4_step(s, torque, DT)
        theta1 = _wrap(ns[0], -jnp.pi, jnp.pi)
        theta2 = _wrap(ns[1], -jnp.pi, jnp.pi)
        dtheta1 = jnp.clip(ns[2], -MAX_VEL_1, MAX_VEL_1)
        dtheta2 = jnp.clip(ns[3], -MAX_VEL_2, MAX_VEL_2)
        new_state = AcrobotState(
            theta1=theta1, theta2=theta2, dtheta1=dtheta1, dtheta2=dtheta2,
            t=state.t + 1,
        )
        terminated = (-jnp.cos(theta1) - jnp.cos(theta2 + theta1)) > 1.0
        truncated = jnp.logical_and(
            new_state.t >= params.max_steps_in_episode, jnp.logical_not(terminated)
        )
        reward = jnp.where(terminated, 0.0, -1.0).astype(jnp.float32)
        return self.get_obs(new_state, params), new_state, reward, terminated, truncated
