"""DQN learner: train state, optimizer builder, update step, ε schedules.

Replaces the reference's ``generate_train_step``
(``/root/reference/General/QLearning/q_learning_functions.py:14-28``) and the
host-side pieces of ``Agent`` (``q_agent.py``): ε-greedy policy
(``q_agent.py:137-141`` — host ``random.uniform``), per-episode ε decay
(``q_agent.py:120-121``), and hard target sync (``q_agent.py:143-144``).
Everything here is a pure function on a :class:`TrainState` pytree so the
whole learner fuses into the jitted superstep — zero host round-trips.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from deep_q_learning_tpu import struct

from deep_q_learning_tpu.config import DQNConfig
from deep_q_learning_tpu.replay.nstep import LearnBatch
from deep_q_learning_tpu.algos.losses import build_loss_fn


@struct.dataclass
class HyperParams:
    """Runtime (traced) hyperparameters.

    These live in the runner state instead of being baked into the jaxpr, so
    HPO trials and schedule tweaks reuse ONE compiled superstep (a lander
    superstep takes tens of seconds to compile).  Values that change program
    structure or shapes (batch size, cadences, network width, replay kind)
    remain static in :class:`~deep_q_learning_tpu.config.DQNConfig`."""

    gamma: jax.Array
    eps_start: jax.Array
    eps_min: jax.Array
    eps_decay: jax.Array
    eps_decay_steps: jax.Array
    # optimizer (applied through optax.inject_hyperparams; see make_optimizer)
    learning_rate: jax.Array
    max_grad_norm: jax.Array  # unused when cfg.max_grad_norm is None
    target_tau: jax.Array  # unused when cfg.target_tau is None (hard sync)
    # replay
    per_beta: jax.Array  # importance-weight exponent (uniform replay ignores)
    # cadences (int32; gate `lax.cond` predicates — changing them does NOT
    # change program structure, so they can be traced)
    train_every: jax.Array
    training_start: jax.Array
    target_sync_every: jax.Array
    target_replace_episodes: jax.Array

    @classmethod
    def from_config(cls, cfg: DQNConfig) -> "HyperParams":
        return cls(
            gamma=jnp.float32(cfg.gamma),
            eps_start=jnp.float32(cfg.eps_start),
            eps_min=jnp.float32(cfg.eps_min),
            eps_decay=jnp.float32(cfg.eps_decay),
            eps_decay_steps=jnp.float32(cfg.eps_decay_steps),
            learning_rate=jnp.float32(cfg.learning_rate),
            max_grad_norm=jnp.float32(
                cfg.max_grad_norm if cfg.max_grad_norm is not None else jnp.inf
            ),
            target_tau=jnp.float32(
                cfg.target_tau if cfg.target_tau is not None else 0.0
            ),
            per_beta=jnp.float32(cfg.per_beta),
            train_every=jnp.int32(cfg.train_every),
            training_start=jnp.int32(cfg.training_start),
            target_sync_every=jnp.int32(cfg.target_sync_every),
            target_replace_episodes=jnp.int32(cfg.target_replace_episodes),
        )


@struct.dataclass
class TrainState:
    """Learner state: online/target params, optimizer state, update counter.

    The reference scatters these across ``Agent`` attributes
    (``q_agent.py:88-114``); as one pytree they can be donated, checkpointed,
    and replicated across the mesh atomically."""

    params: Any
    target_params: Any
    opt_state: Any
    updates: jax.Array  # int32: number of gradient updates applied


_OPTIMIZERS = {
    "adamw": optax.adamw,
    "adam": optax.adam,
    "rmsprop": optax.rmsprop,
    "sgd": optax.sgd,
}


def make_optimizer(cfg: DQNConfig) -> optax.GradientTransformation:
    """Optimizer from config (ref uses adamw lr 2e-4, Test/lunar_lander.py:49;
    the HPO script uses adam lr 1e-4, Test/lunar_lander_hyper_params.py:41).

    Wrapped in ``optax.inject_hyperparams`` so the learning rate (and clip
    norm, when enabled) live in ``opt_state.hyperparams`` as TRACED values —
    the update step overwrites them from :class:`HyperParams` each call, so
    LR sweeps reuse one compiled superstep."""
    if cfg.optimizer not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    ctor = _OPTIMIZERS[cfg.optimizer]
    if cfg.max_grad_norm is not None:

        def clipped(learning_rate, max_grad_norm):
            return optax.chain(
                optax.clip_by_global_norm(max_grad_norm), ctor(learning_rate)
            )

        return optax.inject_hyperparams(clipped)(
            learning_rate=cfg.learning_rate, max_grad_norm=cfg.max_grad_norm
        )
    return optax.inject_hyperparams(ctor)(learning_rate=cfg.learning_rate)


def init_train_state(
    network, optimizer: optax.GradientTransformation, key: jax.Array, obs_dim: int
) -> TrainState:
    dummy = jnp.zeros((1, obs_dim), jnp.float32)
    params = network.init(key, dummy)
    # Distinct buffers for target_params: the runner pytree is donated every
    # superstep, and XLA rejects donating the same buffer twice.
    target_params = jax.tree.map(jnp.copy, params)
    return TrainState(
        params=params,
        target_params=target_params,
        opt_state=optimizer.init(params),
        updates=jnp.int32(0),
    )


# ---------------------------------------------------------------------------
# ε-greedy policy + schedules (fully on device)
# ---------------------------------------------------------------------------

def epsilon_by_schedule(
    cfg: DQNConfig,
    env_steps: jax.Array,
    episodes: jax.Array,
    hyper: Optional[HyperParams] = None,
) -> jax.Array:
    """Exploration rate as a pure function of progress counters.

    "exp_episode" reproduces the reference's per-episode multiplicative decay
    with floor ``ε = max(ε0·decay^episodes, ε_min)`` (q_agent.py:120-121 —
    applied once per episode there; expressed in closed form here so it needs
    no mutable host state).  The reference counts the episodes of its single
    env; ``episodes`` here is the GLOBAL count across all vectorized
    instances, so it is rescaled by ``num_envs`` to keep the reference's
    per-env-episode decay rate at any vector width (without this, N envs
    decay ~N× faster).  "linear_step" is the standard per-env-step linear
    schedule for large vectorized runs.  The schedule KIND is static; its
    parameters come from ``hyper`` (runtime values) when given, else the
    config."""
    h = hyper if hyper is not None else HyperParams.from_config(cfg)
    if cfg.eps_schedule == "exp_episode":
        per_env_episodes = episodes.astype(jnp.float32) / cfg.num_envs
        eps = h.eps_start * h.eps_decay**per_env_episodes
        return jnp.maximum(eps, h.eps_min)
    elif cfg.eps_schedule == "linear_step":
        frac = jnp.clip(env_steps.astype(jnp.float32) / h.eps_decay_steps, 0.0, 1.0)
        return h.eps_start + frac * (h.eps_min - h.eps_start)
    else:
        raise ValueError(f"unknown eps_schedule {cfg.eps_schedule!r}")


def epsilon_greedy(
    key: jax.Array, q_values: jax.Array, epsilon: jax.Array
) -> jax.Array:
    """Batched ε-greedy on device (replaces host RNG at q_agent.py:137-141).

    One uniform draw serves both decisions: ``u < ε`` explores, and
    conditioned on that, ``u/ε`` is again uniform — so ``floor(u/ε · A)`` is
    a uniform random action.  Halves the per-frame PRNG work (threefry is a
    software cipher)."""
    n, num_actions = q_values.shape
    greedy = jnp.argmax(q_values, axis=-1)
    u = jax.random.uniform(key, (n,))
    explore = u < epsilon
    random_actions = jnp.minimum(
        (u / jnp.maximum(epsilon, 1e-9) * num_actions).astype(jnp.int32),
        num_actions - 1,
    )
    return jnp.where(explore, random_actions, greedy).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Gradient update
# ---------------------------------------------------------------------------

def build_update_step(
    apply_fn: Callable,
    optimizer: optax.GradientTransformation,
    cfg: DQNConfig,
    axis_name: Optional[str] = None,
) -> Callable:
    """Returns ``update(ts, batch, weights, hyper=None) -> (ts, loss, td_errors)``.

    When ``axis_name`` is set (shard_map over the "env" mesh axis), gradients
    and the loss are ``pmean``-ed across shards so the replicated learner
    stays bit-identical on every device — the gradient all-reduce of the
    design (SURVEY.md §5.8).

    ``hyper`` (a :class:`HyperParams`) supplies the traced learning rate /
    clip norm / Polyak tau; when omitted, the values baked into the optimizer
    state at init (i.e. the config's) apply."""
    if cfg.ref_terminal_quirk and cfg.n_step != 1:
        raise ValueError("ref_terminal_quirk reproduces 1-step semantics; set n_step=1")
    loss_fn = build_loss_fn(
        apply_fn,
        double=cfg.double,
        loss=cfg.loss,
        huber_delta=cfg.huber_delta,
        ref_terminal_quirk=cfg.ref_terminal_quirk,
    )

    def update(
        ts: TrainState,
        batch: LearnBatch,
        weights: jax.Array,
        hyper: Optional[HyperParams] = None,
    ) -> Tuple[TrainState, jax.Array, jax.Array]:
        (loss, td_err), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            ts.params, ts.target_params, batch, weights
        )
        if axis_name is not None:
            grads = jax.lax.pmean(grads, axis_name)
            loss = jax.lax.pmean(loss, axis_name)
        opt_state = ts.opt_state
        if hyper is not None and hasattr(opt_state, "hyperparams"):
            # overwrite the injected optimizer hyperparams with the runtime
            # (traced) values — LR sweeps without recompiling
            hp = dict(opt_state.hyperparams)
            hp["learning_rate"] = jnp.asarray(
                hyper.learning_rate, hp["learning_rate"].dtype
            )
            if "max_grad_norm" in hp:
                hp["max_grad_norm"] = jnp.asarray(
                    hyper.max_grad_norm, hp["max_grad_norm"].dtype
                )
            opt_state = opt_state._replace(hyperparams=hp)
        updates, opt_state = optimizer.update(grads, opt_state, ts.params)
        params = optax.apply_updates(ts.params, updates)
        if cfg.target_tau is not None:
            # Polyak soft target update every gradient step (alternative to
            # the reference's periodic hard copy, q_agent.py:143-144)
            tau = cfg.target_tau if hyper is None else hyper.target_tau
            target_params = jax.tree.map(
                lambda t, p: (1.0 - tau) * t + tau * p, ts.target_params, params
            )
        else:
            target_params = ts.target_params
        return (
            TrainState(
                params=params,
                target_params=target_params,
                opt_state=opt_state,
                updates=ts.updates + 1,
            ),
            loss,
            td_err,
        )

    return update


def sync_target(ts: TrainState) -> TrainState:
    """Hard target-network copy (ref ``q_agent.py:143-144``)."""
    return ts.replace(target_params=ts.params)
