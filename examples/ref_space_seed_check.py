"""Seed-robustness check of the reference-space HPO negative result.

VERDICT r3 weak #7: the "the reference's own search bounds cannot reach
solving on the fidelity engine" finding (artifacts/hpo_ref_space_jointed.json,
best true eval +19.5 over 24 trials at 8M steps) rested on a single train
seed.  This harness re-trains the best-found config with K independent seeds
as ONE vmapped population (per-member network init + env streams) and records
the eval spread, pinning the result against seed luck.

Run on the GPU:
    python examples/ref_space_seed_check.py

Writes artifacts/ref_space_seed_check.json.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from deep_q_learning_tpu.config import lunar_ref_parity
from deep_q_learning_tpu.parallel.population import PopulationTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = 3
STEPS = 8_000_000  # the original per-trial budget


def main() -> None:
    src = json.load(open(os.path.join(REPO, "artifacts", "hpo_ref_space_jointed.json")))
    best = src["best_params"]
    # the search's base: lunar_ref_parity vectorized to 128 envs (static
    # fields from the best trial applied; runtime fields via hyper overrides)
    base = dataclasses.replace(
        lunar_ref_parity(),
        num_envs=128,
        steps_per_superstep=128,
        batch_size=int(best["batch_size"]),
    )
    runtime = {
        k: best[k]
        for k in (
            "gamma",
            "eps_start",
            "eps_decay",
            "eps_min",
            "train_every",
            "target_replace_episodes",
        )
    }
    trainer = PopulationTrainer(base, num_members=SEEDS, eval_envs=32)
    # identical hyperparams on every member; members differ ONLY by their
    # init key (network init + env reset streams) = independent seeds
    res = trainer.run(
        max_env_steps=STEPS,
        hyper_overrides={k: [v] * SEEDS for k, v in runtime.items()},
        seed=123,
        verbose=True,
    )
    out = {
        "what": (
            "best reference-space config re-trained with "
            f"{SEEDS} independent seeds (one vmapped population)"
        ),
        "config": {**{"batch_size": int(best["batch_size"])}, **runtime},
        "env_steps": int(res["env_steps"]),
        "eval_mean_per_seed": [round(float(x), 1) for x in res["eval_mean"]],
        "window_mean_per_seed": [round(float(x), 1) for x in res["window_mean"]],
        "best_seed_eval": round(float(np.max(res["eval_mean"])), 1),
        "original_single_seed_objective": src["best_objective"],
        "conclusion_holds": bool(np.max(res["eval_mean"]) < 200.0),
    }
    path = os.path.join(REPO, "artifacts", "ref_space_seed_check.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
