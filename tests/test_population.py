"""Population training (vmapped superstep with per-member traced
hyperparameters) — CPU backend via conftest."""

import dataclasses

import jax
import numpy as np
import pytest

from deep_q_learning_tpu.config import cartpole_vector
from deep_q_learning_tpu.parallel import (
    build_population,
    candidate_overrides,
    set_population_hyper,
    train_population,
)

TINY = dataclasses.replace(
    cartpole_vector(),
    num_envs=8,
    steps_per_superstep=8,
    hidden=(16, 16),
    batch_size=16,
    buffer_capacity=512,
    training_start=32,
    return_window=8,
)


def test_population_members_independent():
    init_population, population_step, _ = build_population(TINY, num_members=3)
    runner = init_population(jax.random.PRNGKey(0))
    # independent inits: member params differ
    w = runner.train.params["params"]["trunk_0"]["kernel"]
    assert w.shape[0] == 3
    assert not np.allclose(np.asarray(w[0]), np.asarray(w[1]))

    step = jax.jit(population_step, donate_argnums=0)
    for _ in range(10):
        runner, metrics = step(runner)
    assert metrics.env_steps.shape == (3,)
    assert int(metrics.env_steps[0]) == 80
    # each member trained: finite per-member losses once past warmup
    assert np.all(np.isfinite(np.asarray(metrics.loss_sum)))


def test_per_member_hyperparams_diverge_training():
    """Members with different learning rates must produce different params
    from identical data schedules ONLY via the traced hyperparams."""
    init_population, population_step, _ = build_population(TINY, num_members=2)
    runner = init_population(jax.random.PRNGKey(1))
    # identical init for both members so the hyperparam is the only difference
    tied = jax.tree.map(lambda x: x.at[1].set(x[0]), runner.train)
    runner = runner.replace(train=tied)
    runner = set_population_hyper(runner, learning_rate=[1e-4, 1e-2])
    step = jax.jit(population_step, donate_argnums=0)
    for _ in range(10):
        runner, _ = step(runner)
    w = np.asarray(runner.train.params["params"]["trunk_0"]["kernel"])
    assert not np.allclose(w[0], w[1])


def test_set_population_hyper_validation():
    init_population, _, _ = build_population(TINY, num_members=2)
    runner = init_population(jax.random.PRNGKey(0))
    with pytest.raises(ValueError):
        set_population_hyper(runner, batch_size=32)  # static, not runtime
    with pytest.raises(ValueError):
        set_population_hyper(runner, gamma=[0.9, 0.99, 0.999])  # wrong length


def test_population_with_per_trains():
    """Prioritized replay and double DQN under the member vmap: the
    lunar_per-style learner path (PER sample, priority update) batched over
    members."""
    cfg = dataclasses.replace(TINY, replay="prioritized", double=True)
    init_population, population_step, _ = build_population(cfg, num_members=2)
    runner = init_population(jax.random.PRNGKey(0))
    step = jax.jit(population_step, donate_argnums=0)
    for _ in range(4):
        runner, m = step(runner)
    assert np.isfinite(np.asarray(m.window_mean)).all()
    assert np.asarray(m.loss_count).min() > 0  # every member's learner ran
    # members keep their own priorities (per-member replay state)
    pri = np.asarray(runner.replay.priorities)
    assert pri.shape[0] == 2 and not np.array_equal(pri[0], pri[1])
    w = np.asarray(m.window_mean)
    assert w.shape == (2,)


def test_train_population_end_to_end():
    cands = [
        {"learning_rate": 1e-3, "gamma": 0.99},
        {"learning_rate": 3e-4, "gamma": 0.97},
    ]
    res = train_population(
        TINY,
        num_members=2,
        max_env_steps=512,
        hyper_overrides=candidate_overrides(cands),
        eval_envs=8,
    )
    assert res["window_mean"].shape == (2,)
    assert res["eval_mean"].shape == (2,)
    assert res["env_steps"] >= 512
    assert np.all(np.isfinite(res["eval_mean"]))


def test_eval_env_matches_training_engine():
    """Train and eval envs must share the physics engine / param overrides
    (VERDICT r3 weak #2: a rigid-engine preset was silently eval'd on the
    jointed default engine, contaminating every population artifact)."""
    from deep_q_learning_tpu.parallel.population import PopulationTrainer

    lunar = dataclasses.replace(
        TINY,
        env_id="LunarLander-v2",
        time_fraction_obs=True,
        max_steps_in_episode=64,
        lander_engine="rigid",
    )
    trainer = PopulationTrainer(lunar, num_members=2, eval_envs=4)
    assert trainer._eval_env_params.jointed is False
    jointed = dataclasses.replace(lunar, lander_engine="jointed")
    trainer2 = PopulationTrainer(jointed, num_members=2, eval_envs=4)
    assert trainer2._eval_env_params.jointed is True
    assert trainer2._eval_env_params.vel_iters == jointed.lander_vel_iters
