"""Mesh-sharded actor-learner: envs sharded, learner replicated.

This is BASELINE.json config 5 ("Multi-host DDQN: envs sharded over 2+ hosts,
sharded learner with gradient allreduce") — net-new scope over the
reference, which is single-device (SURVEY.md §2, §5.8).

Layout over the 1-D ``("env",)`` mesh:
  * env states / observations / per-env accumulators: sharded on their
    leading env axis (``P("env")``); replay storage, slot-major, on its env
    axis 1 (``P(None, "env")``) — every shard steps its own envs and writes
    its own replay shard, no cross-shard traffic;
  * learner (params, target params, optimizer state): replicated (``P()``);
    each shard samples a local sub-batch, computes gradients, and
    ``lax.pmean`` inside the update (``algos/dqn.py``) all-reduces them
    (NCCL across GPUs, NVLink within a host), keeping the replicated learner
    bit-identical on every device;
  * per-shard loop counters / RNG / metric windows: one slot per shard,
    sharded on a leading ``(num_shards,)`` axis.

The shard body is the SAME ``build_superstep`` used single-device — the mesh
program is the single-chip program plus one collective, which is what makes
1-card-to-many scaling a layout change rather than a rewrite.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from deep_q_learning_tpu.config import DQNConfig
from deep_q_learning_tpu.envs import VectorEnv, make_env
from deep_q_learning_tpu.models import QNetwork
from deep_q_learning_tpu.replay import make_replay
from deep_q_learning_tpu.algos import build_superstep, make_optimizer
from deep_q_learning_tpu.algos.superstep import RunnerState, SuperstepMetrics
from deep_q_learning_tpu.parallel.mesh import ENV_AXIS


def _runner_specs(example: RunnerState, replay) -> RunnerState:
    """PartitionSpec pytree matching RunnerState: learner replicated,
    everything else sharded on its leading (env or shard) axis; replay
    sharding is delegated to the replay implementation."""
    train_specs = jax.tree.map(lambda _: P(), example.train)
    shard = lambda tree: jax.tree.map(lambda _: P(ENV_AXIS), tree)
    return RunnerState(
        train=train_specs,
        hyper=jax.tree.map(lambda _: P(), example.hyper),  # replicated
        env_states=shard(example.env_states),
        obs=P(ENV_AXIS),
        replay=replay.shard_specs(example.replay, ENV_AXIS),
        rng=P(ENV_AXIS),
        env_step=P(ENV_AXIS),
        episodes=P(ENV_AXIS),
        last_sync_episodes=P(ENV_AXIS),
        ep_return=P(ENV_AXIS),
        ep_length=P(ENV_AXIS),
        return_window=P(ENV_AXIS),
        window_cursor=P(ENV_AXIS),
        window_filled=P(ENV_AXIS),
    )


def _to_local(g: RunnerState, replay) -> RunnerState:
    """Strip the per-shard leading axis from scalar-per-shard leaves (inside
    shard_map each block has local shape (1, ...))."""
    return RunnerState(
        train=g.train,
        hyper=g.hyper,
        env_states=g.env_states,
        obs=g.obs,
        replay=replay.to_local(g.replay),
        rng=g.rng[0],
        env_step=g.env_step[0],
        episodes=g.episodes[0],
        last_sync_episodes=g.last_sync_episodes[0],
        ep_return=g.ep_return,
        ep_length=g.ep_length,
        return_window=g.return_window[0],
        window_cursor=g.window_cursor[0],
        window_filled=g.window_filled[0],
    )


def _to_global(l: RunnerState, replay) -> RunnerState:
    """Re-add the (1,) per-shard axis on scalar-per-shard leaves."""
    one = lambda x: jnp.asarray(x)[None]
    return RunnerState(
        train=l.train,
        hyper=l.hyper,
        env_states=l.env_states,
        obs=l.obs,
        replay=replay.to_global(l.replay),
        rng=one(l.rng),
        env_step=one(l.env_step),
        episodes=one(l.episodes),
        last_sync_episodes=one(l.last_sync_episodes),
        ep_return=l.ep_return,
        ep_length=l.ep_length,
        return_window=one(l.return_window),
        window_cursor=one(l.window_cursor),
        window_filled=one(l.window_filled),
    )


def build_distributed_superstep(
    cfg: DQNConfig, mesh: Mesh
) -> Tuple[Callable, Callable, object]:
    """Build ``(init_runner, superstep, network)`` sharded over ``mesh``.

    ``init_runner(key) -> RunnerState`` returns a GLOBAL runner whose leaves
    carry the mesh shardings above; ``superstep(runner)`` is the jittable
    mesh program (donate the runner at the call site).
    """
    num_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    if cfg.num_envs % num_shards != 0:
        raise ValueError(
            f"num_envs={cfg.num_envs} not divisible by mesh size {num_shards}"
        )
    local_envs = cfg.num_envs // num_shards

    env, env_params = make_env(
        cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode,
        param_overrides=cfg.env_param_overrides(),
    )
    venv = VectorEnv(env, local_envs)
    network = QNetwork(
        num_actions=env.num_actions,
        hidden=cfg.hidden,
        dueling=cfg.dueling,
        compute_dtype=jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32,
    )
    optimizer = make_optimizer(cfg)
    # per-shard batch: the global batch is split evenly across shards
    if cfg.batch_size % num_shards != 0:
        raise ValueError(
            f"batch_size={cfg.batch_size} not divisible by mesh size {num_shards}"
        )
    import dataclasses

    local_cfg = dataclasses.replace(
        cfg, num_envs=local_envs, batch_size=cfg.batch_size // num_shards
    )
    replay = make_replay(cfg, num_envs=local_envs)
    init_local, superstep_local = build_superstep(
        venv,
        env_params,
        network,
        optimizer,
        replay,
        local_cfg,
        axis_name=ENV_AXIS,
        num_shards=num_shards,
    )

    # specs come from an eval-shaped example (structure only, built abstractly)
    example = jax.eval_shape(
        lambda k: _to_global(init_local(k, net_key=k), replay), jax.random.PRNGKey(0)
    )
    specs = _runner_specs(example, replay)
    # metrics are reduced IN-GRAPH over the env axis (psum/pmean ride NCCL
    # on GPUs, Gloo on the multi-process CPU backend) and come back
    # fully replicated — so the host can read them as plain scalars even when
    # this process only addresses a subset of the mesh (multi-process safe;
    # per-shard metric slots would be non-addressable off-host).
    metric_specs = jax.tree.map(
        lambda _: P(),
        SuperstepMetrics(
            env_steps=0, episodes=0, episodes_delta=0, return_sum_delta=0.0,
            loss_sum=0.0, loss_count=0.0, window_mean=0.0, epsilon=0.0, solved=False,
        ),
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(ENV_AXIS), P()),
        out_specs=specs,
        check_vma=False,
    )
    def _init_sharded(shard_keys, net_key):
        return _to_global(init_local(shard_keys[0], net_key=net_key), replay)

    def init_runner(key: jax.Array) -> RunnerState:
        # keys cross the host->global-mesh boundary as numpy: every process
        # computes the same values, so jax can form the global (sharded)
        # inputs without cross-process transfers from a single-device array
        net_key, env_key = jax.random.split(key)
        shard_keys = np.asarray(jax.random.split(env_key, num_shards))
        return _init_sharded(shard_keys, np.asarray(net_key))

    def _reduce_metrics(m: SuperstepMetrics) -> SuperstepMetrics:
        psum = lambda x: jax.lax.psum(x, ENV_AXIS)
        return SuperstepMetrics(
            # lockstep-identical per shard; pmax makes replication explicit
            env_steps=jax.lax.pmax(m.env_steps, ENV_AXIS),
            episodes=psum(m.episodes),
            episodes_delta=psum(m.episodes_delta),
            return_sum_delta=psum(m.return_sum_delta),
            loss_sum=psum(m.loss_sum),
            loss_count=psum(m.loss_count),
            window_mean=jax.lax.pmean(m.window_mean, ENV_AXIS),
            epsilon=jax.lax.pmax(m.epsilon, ENV_AXIS),
            # solved only when EVERY shard's window clears the threshold
            solved=jax.lax.pmin(m.solved.astype(jnp.int32), ENV_AXIS).astype(bool),
        )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(specs,),
        out_specs=(specs, metric_specs),
        check_vma=False,
    )
    def superstep(g: RunnerState):
        local, metrics = superstep_local(_to_local(g, replay))
        return _to_global(local, replay), _reduce_metrics(metrics)

    return init_runner, superstep, network


def aggregate_metrics(m: SuperstepMetrics, cfg: DQNConfig, num_shards: int = 1) -> dict:
    """Convert the (replicated, already cross-shard-reduced) metrics pytree to
    host scalars.  Replicated arrays are fully addressable from every process,
    so this is multi-process safe (``num_shards`` kept for API compatibility;
    the reduction itself happens in-graph)."""
    return {
        "env_steps": int(m.env_steps) * cfg.num_envs,  # lockstep vector steps
        "episodes": int(m.episodes),
        "episodes_delta": int(m.episodes_delta),
        "return_sum_delta": float(m.return_sum_delta),
        "loss": float(m.loss_sum) / max(float(m.loss_count), 1.0),
        "window_mean": float(m.window_mean),
        "epsilon": float(m.epsilon),
        "solved": bool(m.solved),
    }
