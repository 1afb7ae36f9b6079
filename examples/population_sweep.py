"""Train K agents with different hyperparameters CONCURRENTLY on one chip.

The reference evaluates hyperparameter candidates as 20 sequential training
runs (``/root/reference/General/QLearning/hyperparameter_optimization.py:
126-132``).  Here the candidate axis is a vmap axis: each member owns its env
states, replay buffer, network init, and traced hyperparameters, and all of
them advance in ONE compiled superstep (``parallel/population.py``).

Usage:
    python examples/population_sweep.py [--members 8] [--steps 40000000]
    python examples/population_sweep.py --param gamma --low 0.9 --high 0.999
"""

import argparse
import dataclasses
import json

import numpy as np

from deep_q_learning_tpu.config import PRESETS
from deep_q_learning_tpu.parallel import train_population


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", type=str, default="cartpole_vector")
    ap.add_argument("--members", type=int, default=8)
    ap.add_argument("--steps", type=int, default=40_000_000,
                    help="TOTAL env-step budget per member")
    ap.add_argument("--param", type=str, default="learning_rate",
                    help="runtime hyperparameter to sweep (geomspace)")
    ap.add_argument("--low", type=float, default=3e-5)
    ap.add_argument("--high", type=float, default=3e-2)
    ap.add_argument("--num-envs", type=int, default=2048, help="per member")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=None, help="result JSON path")
    args = ap.parse_args()

    cfg = dataclasses.replace(
        PRESETS[args.preset](), num_envs=args.num_envs
    )
    values = np.geomspace(args.low, args.high, args.members)
    res = train_population(
        cfg,
        num_members=args.members,
        max_env_steps=args.steps,
        hyper_overrides={args.param: values},
        seed=args.seed,
        verbose=True,
    )
    rows = sorted(
        zip(values, res["window_mean"], res["eval_mean"]),
        key=lambda r: -r[2],
    )
    print(f"\n{args.param:>16s}  {'window':>8s}  {'eval':>8s}")
    for v, w, e in rows:
        print(f"{v:16.6g}  {w:8.1f}  {e:8.1f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(
                {
                    "param": args.param,
                    "values": [float(v) for v in values],
                    "window_mean": res["window_mean"].tolist(),
                    "eval_mean": res["eval_mean"].tolist(),
                    "env_steps": res["env_steps"],
                },
                f,
                indent=1,
            )


if __name__ == "__main__":
    main()
