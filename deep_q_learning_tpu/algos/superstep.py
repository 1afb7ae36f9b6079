"""The fused actor-learner "superstep" — the heart of the device-resident design.

The reference interleaves host Python between every environment step and
crosses the host<->device boundary four times per training step
(SURVEY.md §3.1-3.2: ``q_agent.py:171-207`` drives gym on the host, then calls
four separately-jitted functions).  Here the *entire* inner loop — K vector
env steps, ε-greedy action selection, replay writes, gradient updates, target
sync, and metric accumulation — is ONE jitted function built around
``lax.fori_loop``: zero host round-trips per step, state donated between
calls, and every cadence (train_every, target sync) expressed as
``lax.cond`` on device counters.

Episode accounting is also on device: per-env running returns, a ring window
of the last W completed episode returns (the reference's 50-episode average,
``q_agent.py:123-126``), and a ``solved`` flag the host polls once per
superstep (``q_agent.py:219-222``'s termination check, at superstep cadence).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from deep_q_learning_tpu import struct

from deep_q_learning_tpu.config import DQNConfig
from deep_q_learning_tpu.envs.base import Transition, VectorEnv
from deep_q_learning_tpu.replay.uniform import ReplayState, UniformReplay
from deep_q_learning_tpu.algos.dqn import (
    HyperParams,
    TrainState,
    build_update_step,
    epsilon_by_schedule,
    epsilon_greedy,
    init_train_state,
    sync_target,
)


@struct.dataclass
class RunnerState:
    """Everything the training loop owns, as one donatable pytree."""

    train: TrainState
    hyper: HyperParams  # runtime hyperparams (traced; swap without recompile)
    env_states: Any  # vmapped env state, leaves (N, ...)
    obs: jax.Array  # (N, D) current observations
    replay: ReplayState
    rng: jax.Array
    env_step: jax.Array  # int32: vector steps taken (aggregate steps = *N)
    episodes: jax.Array  # int32: completed episodes
    last_sync_episodes: jax.Array  # int32: episodes count at last target sync
    ep_return: jax.Array  # (N,) float32 running return per env
    ep_length: jax.Array  # (N,) int32 running length per env
    return_window: jax.Array  # (W,) float32 ring of completed returns
    window_cursor: jax.Array  # int32
    window_filled: jax.Array  # int32


@struct.dataclass
class SuperstepMetrics:
    env_steps: jax.Array  # VECTOR steps so far (aggregate = env_steps * num_envs)
    episodes: jax.Array  # completed episodes so far
    episodes_delta: jax.Array  # completed during this superstep
    return_sum_delta: jax.Array  # sum of returns completed this superstep
    loss_sum: jax.Array
    loss_count: jax.Array
    window_mean: jax.Array  # mean of last-W completed episode returns
    epsilon: jax.Array
    solved: jax.Array  # bool: window full and mean >= threshold


def _scatter_completed_returns(
    window: jax.Array,
    cursor: jax.Array,
    filled: jax.Array,
    done: jax.Array,
    returns: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Write the returns of all envs that finished this step into the ring
    window (multiple completions per vector step supported: each finished env
    gets its rank-among-finished as an offset from the cursor).

    Implementation: a naive ``window.at[idx].set`` is an XLA scatter with
    (potentially) colliding indices.  Two exact rewrites replace it:

    1. Only the LAST ``W`` completions (by rank) can survive the ring, and
       restricted to those the target slots are UNIQUE — so "last writer
       wins" scatter semantics reduce to a collision-free one-hot sum.
    2. A flat (N, W) one-hot still materializes N·W elements (268 MB at
       N=131072, W=512).  Factor the slot as ``slot = b·W2 + a`` and
       contract the two *residue* one-hots — (N, W2) and (N, W1) with
       W1·W2 ≥ W — through a single matmul ``(2·W1, N) @ (N, W2)`` that
       carries both the written values and the write counts.  Cost scales
       with N·(W2 + 2·W1) ≈ N·√W instead of N·W.  The matmul runs at
       HIGHEST precision: each output sums one value with zeros, so it is
       exact, where a TF32 product would round the returns.

    Final window contents are bit-identical to in-order scatter semantics."""
    w = window.shape[0]
    done_i = done.astype(jnp.int32)
    rank = jnp.cumsum(done_i) - 1  # rank among finished, in env order
    num_done = jnp.sum(done_i)
    # keep only the final w writers; their ring slots are then unique
    sel = jnp.logical_and(done, rank >= num_done - w)
    slot = jnp.where(sel, (cursor + rank) % w, 0)  # unselected: masked below
    # factor w = w1*w2 (w2 ~ sqrt(2w), power of two; w1 = ceil(w/w2))
    w2 = 1
    while w2 * w2 < 2 * w:
        w2 *= 2
    w2 = min(w2, w)
    w1 = -(-w // w2)
    a = slot % w2  # (N,) minor residue
    b = slot // w2  # (N,) major residue
    onehot_a = (a[:, None] == jnp.arange(w2)[None, :]).astype(returns.dtype)
    selm = sel.astype(returns.dtype)
    onehot_b = (b[:, None] == jnp.arange(w1)[None, :]).astype(returns.dtype)
    onehot_b = onehot_b * selm[:, None]  # (N, W1), zero rows for non-writers
    # one matmul carries values (top W1 rows) and counts (bottom W1 rows)
    packed = jnp.concatenate([onehot_b * returns[:, None], onehot_b], axis=1)
    out = jnp.matmul(
        packed.T, onehot_a, precision=jax.lax.Precision.HIGHEST
    )  # (2*W1, W2)
    written = out[:w1].reshape(w1 * w2)[:w]
    wrote = out[w1:].reshape(w1 * w2)[:w] > 0.5
    window = jnp.where(wrote, written, window)
    cursor = (cursor + num_done) % w
    filled = jnp.minimum(filled + num_done, w)
    return window, cursor, filled


def build_superstep(
    venv: VectorEnv,
    env_params: Any,
    network,
    optimizer,
    replay: UniformReplay,
    cfg: DQNConfig,
    axis_name: Optional[str] = None,
    num_shards: int = 1,
) -> Tuple[Callable, Callable]:
    """Build ``(init_runner, superstep)``.

    ``init_runner(key) -> RunnerState`` and
    ``superstep(runner) -> (runner, SuperstepMetrics)`` are pure; the caller
    jits (and optionally shard_maps) ``superstep`` with donated runner state.

    When used as the per-shard body of a mesh program (``parallel/``),
    ``venv`` holds the shard-local envs, ``axis_name`` names the mesh axis for
    the gradient all-reduce, and ``num_shards`` scales step-based schedules
    and warmup gates to GLOBAL env-step units so 1-shard and k-shard runs see
    the same hyperparameter semantics."""
    update = build_update_step(network.apply, optimizer, cfg, axis_name=axis_name)
    num_envs = venv.num_envs
    global_envs = num_envs * num_shards
    (obs_dim,) = venv.obs_shape(env_params)

    def init_runner(key: jax.Array, net_key: Optional[jax.Array] = None) -> RunnerState:
        derived_net_key, env_key, rng = jax.random.split(key, 3)
        if net_key is None:
            net_key = derived_net_key  # single-shard: self-contained
        # multi-shard: caller passes one SHARED net_key so every shard
        # initializes identical (replicated) learner params
        train = init_train_state(network, optimizer, net_key, obs_dim)
        obs, env_states = venv.reset(env_key, env_params)
        example = Transition(
            obs=obs,
            action=jnp.zeros((num_envs,), jnp.int32),
            reward=jnp.zeros((num_envs,), jnp.float32),
            next_obs=obs,
            terminated=jnp.zeros((num_envs,), bool),
            truncated=jnp.zeros((num_envs,), bool),
        )
        return RunnerState(
            train=train,
            hyper=HyperParams.from_config(cfg),
            env_states=env_states,
            obs=obs,
            replay=replay.init(example),
            rng=rng,
            env_step=jnp.int32(0),
            episodes=jnp.int32(0),
            last_sync_episodes=jnp.int32(0),
            ep_return=jnp.zeros((num_envs,), jnp.float32),
            ep_length=jnp.zeros((num_envs,), jnp.int32),
            return_window=jnp.zeros((cfg.return_window,), jnp.float32),
            window_cursor=jnp.int32(0),
            window_filled=jnp.int32(0),
        )

    def _maybe_train(
        rng: jax.Array,
        train: TrainState,
        rstate: ReplayState,
        env_step: jax.Array,
        hyper: HyperParams,
    ) -> Tuple[TrainState, ReplayState, jax.Array, jax.Array]:
        """cfg.updates_per_step gradient updates, gated on cadence + warmup
        (ref gate: ``step % train_frequency == 0 and buffer.size >=
        training_start``, q_agent.py:186-187).  The cadence and warmup
        thresholds are traced (``hyper``), so they can change between calls
        without recompiling.

        Structural rule: the ring storage must NEVER appear inside the
        ``lax.cond`` — as operand OR closure capture — or XLA may insert
        per-frame copies of the touched storage leaves to keep the in-place
        ring write legal.  For the common ``updates_per_step == 1`` case the
        sample/assemble gathers run UNCONDITIONALLY outside the cond
        (harmless before warmup: the update that would consume the garbage
        batch is skipped, and the samplers are division-guarded), and the
        cond carries only the train state and the replay's small
        learner-mutable view (PER priorities).

        The hoisted structure only pays when the learner actually runs
        every frame: with cfg.train_every > 1 the unconditional
        sample/assemble is waste on skipped frames, so those configs keep
        sampling inside the cond.  The structure choice keys on the STATIC
        cfg.train_every; a runtime hyper.train_every override stays correct
        on either path (do_train honors the traced value), it just may not
        pick the cheaper one."""
        # warmup gate in GLOBAL transitions: local filled * global env count
        do_train = jnp.logical_and(
            env_step % hyper.train_every == 0,
            (rstate.filled * global_envs) >= hyper.training_start,
        )

        if cfg.updates_per_step == 1 and cfg.train_every == 1:
            rng, sample_key = jax.random.split(rng)
            batch, info, weights = replay.sample_with_info(
                rstate, sample_key, cfg.batch_size,
                gamma=hyper.gamma, beta=hyper.per_beta,
            )

            def run_one(args):
                train, view = args
                train2, loss, td_err = update(train, batch, weights, hyper)
                rstate2 = replay.update_priorities(
                    replay.with_learner_view(rstate, view), info, td_err
                )
                return (
                    train2,
                    replay.learner_view(rstate2),
                    loss,
                    jnp.float32(1.0),
                )

            def skip_one(args):
                train, view = args
                return train, view, jnp.float32(0.0), jnp.float32(0.0)

            train, view, loss_sum, count = jax.lax.cond(
                do_train, run_one, skip_one, (train, replay.learner_view(rstate))
            )
            return train, replay.with_learner_view(rstate, view), loss_sum, count

        def run_updates(args):
            rng, train, rstate = args

            def one(u, carry):
                rng, train, rstate, loss_sum = carry
                rng, sample_key = jax.random.split(rng)
                batch, info, weights = replay.sample_with_info(
                    rstate, sample_key, cfg.batch_size,
                    gamma=hyper.gamma, beta=hyper.per_beta,
                )
                train, loss, td_err = update(train, batch, weights, hyper)
                # PER: refresh sampled priorities from |td| (no-op for uniform)
                rstate = replay.update_priorities(rstate, info, td_err)
                return rng, train, rstate, loss_sum + loss

            # updates_per_step > 1 only: each update samples against the
            # PREVIOUS update's refreshed priorities, so the full replay
            # state threads through the loop and the cond (and pays the
            # storage-copy tax documented above — acceptable off the
            # headline path; no preset sets updates_per_step > 1).
            init = (rng, train, rstate, jnp.float32(0.0))
            rng, train, rstate, loss_sum = jax.lax.fori_loop(
                0, cfg.updates_per_step, one, init
            )
            return train, rstate, loss_sum, jnp.float32(cfg.updates_per_step)

        def skip(args):
            _, train, rstate = args
            return train, rstate, jnp.float32(0.0), jnp.float32(0.0)

        return jax.lax.cond(do_train, run_updates, skip, (rng, train, rstate))

    def _maybe_sync(runner_train, episodes, last_sync, env_step, hyper):
        """Hard target sync on the configured cadence (ref: every
        ``replace_frequency`` episodes, q_agent.py:192-193).  With
        ``cfg.target_tau`` set, soft updates happen inside the gradient step
        instead and the periodic hard copy is disabled.  Cadence values are
        traced (``hyper``); only the MODE is static."""
        if cfg.target_tau is not None:
            return runner_train, last_sync
        if cfg.target_sync_mode == "steps":
            do_sync = env_step % hyper.target_sync_every == 0
            new_last = last_sync
        elif cfg.target_sync_mode == "episodes":
            # Under the mesh the episode counter is per-shard; the sync
            # predicate must be a GLOBAL decision or shards hard-copy target
            # params at different steps and the replicated learner silently
            # desyncs (VERDICT r3 weak #3).  psum makes the count — and hence
            # do_sync and the stored last_sync — identical on every shard.
            if axis_name is not None:
                episodes = jax.lax.psum(episodes, axis_name)
            k = hyper.target_replace_episodes
            do_sync = (episodes // k) > (last_sync // k)
            new_last = jnp.where(do_sync, episodes, last_sync)
        else:
            raise ValueError(f"unknown target_sync_mode {cfg.target_sync_mode!r}")
        train = jax.lax.cond(do_sync, sync_target, lambda t: t, runner_train)
        return train, new_last

    def superstep(runner: RunnerState) -> Tuple[RunnerState, SuperstepMetrics]:
        # Auto-reset source (ADVICE r3): cheap-reset envs (classic control)
        # draw fresh states per FRAME via one bulk RNG call — exact
        # semantics, consecutive resets always differ.  Physics-reset envs
        # (the lander: terrain + one solver frame per entry) hoist ONE pool
        # per superstep; an env finishing twice within the window replays
        # its entry, which the lander's per-frame engine dispersion noise
        # immediately decorrelates (VectorEnv.step docstring).
        pool_rng, start_rng = jax.random.split(runner.rng)
        runner = runner.replace(rng=start_rng)
        if venv.env.batch_reset_cheap:
            fresh = None
        else:
            with jax.named_scope("reset_pool"):
                fresh = venv.fresh_pool(pool_rng, env_params)

        def body(i, carry):
            runner, loss_sum, loss_count, ep_delta, ret_delta = carry
            rng, action_key, env_key, train_key = jax.random.split(runner.rng, 4)

            # --- actor: ε-greedy on device --------------------------------
            # (named scopes label the phases in jax.profiler / xprof traces)
            with jax.named_scope("actor"):
                eps = epsilon_by_schedule(
                    cfg,
                    runner.env_step.astype(jnp.float32) * global_envs,
                    runner.episodes,
                    hyper=runner.hyper,
                )
                q_values = network.apply(runner.train.params, runner.obs)
                actions = epsilon_greedy(action_key, q_values, eps)

            # --- env: vector step with in-graph auto-reset ----------------
            with jax.named_scope("env_step"):
                obs, env_states, transition = venv.step(
                    env_key, runner.env_states, actions, env_params,
                    prev_obs=runner.obs, fresh=fresh,
                )
            with jax.named_scope("replay_write"):
                rstate = replay.add(runner.replay, transition)

            # --- episode accounting ---------------------------------------
            done = jnp.logical_or(transition.terminated, transition.truncated)
            ep_return = runner.ep_return + transition.reward
            ep_length = runner.ep_length + 1
            window, cursor, filled = _scatter_completed_returns(
                runner.return_window,
                runner.window_cursor,
                runner.window_filled,
                done,
                ep_return,
            )
            num_done = jnp.sum(done.astype(jnp.int32))
            episodes = runner.episodes + num_done
            ret_delta = ret_delta + jnp.sum(
                jnp.where(done, ep_return, 0.0)
            )
            ep_delta = ep_delta + num_done
            ep_return = jnp.where(done, 0.0, ep_return)
            ep_length = jnp.where(done, 0, ep_length)

            # --- learner ---------------------------------------------------
            env_step = runner.env_step + 1
            with jax.named_scope("learner"):
                train, rstate, step_loss, step_count = _maybe_train(
                    train_key, runner.train, rstate, env_step, runner.hyper
                )
                train, last_sync = _maybe_sync(
                    train, episodes, runner.last_sync_episodes, env_step,
                    runner.hyper,
                )

            runner = RunnerState(
                train=train,
                hyper=runner.hyper,
                env_states=env_states,
                obs=obs,
                replay=rstate,
                rng=rng,
                env_step=env_step,
                episodes=episodes,
                last_sync_episodes=last_sync,
                ep_return=ep_return,
                ep_length=ep_length,
                return_window=window,
                window_cursor=cursor,
                window_filled=filled,
            )
            return (
                runner,
                loss_sum + step_loss,
                loss_count + step_count,
                ep_delta,
                ret_delta,
            )

        init = (
            runner,
            jnp.float32(0.0),
            jnp.float32(0.0),
            jnp.int32(0),
            jnp.float32(0.0),
        )
        runner, loss_sum, loss_count, ep_delta, ret_delta = jax.lax.fori_loop(
            0, cfg.steps_per_superstep, body, init
        )

        window_mean = jnp.where(
            runner.window_filled > 0,
            jnp.sum(runner.return_window)
            / jnp.maximum(runner.window_filled, 1).astype(jnp.float32),
            jnp.float32(-jnp.inf),
        )
        threshold = cfg.solve_threshold if cfg.solve_threshold is not None else jnp.inf
        solved = jnp.logical_and(
            runner.window_filled >= cfg.return_window, window_mean >= threshold
        )
        metrics = SuperstepMetrics(
            # vector steps; host multiplies by num_envs for aggregate env
            # steps (avoids int32 overflow at >2.1B aggregate on device)
            env_steps=runner.env_step,
            episodes=runner.episodes,
            episodes_delta=ep_delta,
            return_sum_delta=ret_delta,
            loss_sum=loss_sum,
            loss_count=loss_count,
            window_mean=window_mean,
            epsilon=epsilon_by_schedule(
                cfg,
                runner.env_step.astype(jnp.float32) * global_envs,
                runner.episodes,
                hyper=runner.hyper,
            ),
            solved=solved,
        )
        return runner, metrics

    return init_runner, superstep
