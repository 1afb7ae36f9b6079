"""HPO tests: the GP-UCB optimizer on a known function, space handling,
and a tiny end-to-end DQN objective."""

import numpy as np

from deep_q_learning_tpu.hpo import Param, optimize, make_dqn_objective


def test_bo_finds_quadratic_optimum():
    space = (Param("x", -2.0, 4.0), Param("y", -1.0, 3.0))
    calls = []

    def f(p):
        calls.append(p)
        return -((p["x"] - 1.0) ** 2) - (p["y"] - 0.5) ** 2

    res = optimize(f, space, num_trials=25, num_init=6, seed=3, verbose=False)
    assert len(res.trials) == 25
    assert res.best_objective > -0.15, f"BO failed to approach optimum: {res.best_params}"
    assert abs(res.best_params["x"] - 1.0) < 0.45
    assert abs(res.best_params["y"] - 0.5) < 0.45


def test_integer_params_are_cast():
    space = (Param("n", 2, 10, integer=True),)
    seen = []

    def f(p):
        seen.append(p["n"])
        return -abs(p["n"] - 5)

    optimize(f, space, num_trials=6, num_init=3, seed=0, verbose=False)
    assert all(isinstance(n, int) for n in seen)
    assert all(2 <= n <= 10 for n in seen)


def test_beats_random_search_on_budget():
    """The GP-guided half must find a better point than pure random with the
    same total budget on a multi-modal function (sanity of the acquisition)."""
    space = (Param("x", 0.0, 10.0),)

    def f(p):
        x = p["x"]
        return np.sin(x) * 3 + np.exp(-((x - 7.3) ** 2)) * 5

    res = optimize(f, space, num_trials=30, num_init=8, seed=7, verbose=False)
    rng = np.random.RandomState(7)
    random_best = max(
        f({"x": 10 * rng.rand()}) for _ in range(30)
    )
    assert res.best_objective >= random_best - 0.3


def test_dqn_objective_fresh_per_trial():
    from deep_q_learning_tpu.config import DQNConfig

    cfg = DQNConfig(
        env_id="CartPole-v1", num_envs=8, steps_per_superstep=8, batch_size=16,
        training_start=32, buffer_capacity=512, double=False, dueling=False,
        hidden=(16,), train_every=1, eps_schedule="linear_step", return_window=8,
    )
    obj = make_dqn_objective(cfg, env_steps_per_trial=512)
    v1 = obj({"gamma": 0.95, "batch_size": 16})
    v2 = obj({"gamma": 0.95, "batch_size": 16})
    assert np.isfinite(v1) and np.isfinite(v2)
    # same params, fresh trainers with same seed -> identical objective
    assert v1 == v2


def test_batched_bo_finds_quadratic_optimum():
    from deep_q_learning_tpu.hpo.bayesopt import optimize_batched

    space = (Param("x", -2.0, 4.0), Param("y", -1.0, 3.0))
    batches = []

    def f_batch(cands):
        batches.append(len(cands))
        return [-((p["x"] - 1.0) ** 2) - (p["y"] - 0.5) ** 2 for p in cands]

    res = optimize_batched(
        f_batch, space, num_trials=24, batch_q=6, seed=3, verbose=False
    )
    assert len(res.trials) == 24
    assert batches == [6, 6, 6, 6]  # q candidates per round, one call each
    assert res.best_objective > -0.2, f"batched BO missed optimum: {res.best_params}"


def test_population_objective_end_to_end():
    """Population objective: candidates sharing static fields train as one
    vmapped program; distinct batch_size values form separate groups."""
    import dataclasses

    from deep_q_learning_tpu.config import cartpole_vector
    from deep_q_learning_tpu.hpo.bayesopt import make_population_objective

    cfg = dataclasses.replace(
        cartpole_vector(),
        num_envs=8,
        steps_per_superstep=8,
        hidden=(16, 16),
        batch_size=16,
        buffer_capacity=512,
        training_start=32,
        return_window=8,
    )
    objective = make_population_objective(cfg, env_steps_per_trial=256, eval_envs=8)
    cands = [
        {"gamma": 0.99, "learning_rate": 1e-3, "batch_size": 16},
        {"gamma": 0.95, "learning_rate": 3e-4, "batch_size": 16},
        {"gamma": 0.97, "learning_rate": 1e-3, "batch_size": 24},  # own group
    ]
    vals = objective(cands)
    assert len(vals) == 3
    assert all(np.isfinite(v) for v in vals)
    # two static groups: (batch 16, 2 members) and (batch 24, 1 member)
    assert len(objective.trainers) == 2

    # a second round with the same static layout REUSES the built programs
    # (one compile for the whole search; lunar jits cost tens of seconds)
    before = {k: id(v) for k, v in objective.trainers.items()}
    vals2 = objective(cands)
    assert all(np.isfinite(v) for v in vals2)
    assert {k: id(v) for k, v in objective.trainers.items()} == before
