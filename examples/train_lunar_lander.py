"""Train dueling double DQN on LunarLander until solved, then record greedy
rollouts — the rebuild of ``/root/reference/Test/lunar_lander.py:20-86``
(which trains to a 230 window average, pickles the params, and renders 10
greedy episodes).

Differences by design: config is a typed preset instead of module constants;
training runs as fused device supersteps over many lockstep landers instead of
one host-driven Gym env; checkpoints capture the full runner state;
"visualization" records trajectories on device and writes flight-path PNGs
(headless hosts have no render window).

Usage:
    python examples/train_lunar_lander.py [--steps 40000000] [--workdir runs/lunar]
"""

import argparse
import dataclasses

import jax
import numpy as np

from deep_q_learning_tpu.config import PRESETS
from deep_q_learning_tpu.train import Trainer
from deep_q_learning_tpu.utils.metrics import plot_history
from deep_q_learning_tpu.utils.visualize import (
    dump_trajectory,
    plot_lander_flight,
    record_trajectory,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60_000_000)
    ap.add_argument("--preset", type=str, default="lunar_per", choices=["lunar_per", "lunar_dddqn_vector", "lunar_ref_parity"])
    ap.add_argument("--workdir", type=str, default="runs/lunar")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rollouts", type=int, default=10)  # ref renders 10
    args = ap.parse_args()

    cfg = dataclasses.replace(PRESETS[args.preset](), seed=args.seed)
    trainer = Trainer(cfg, workdir=args.workdir).init()
    result = trainer.train(max_env_steps=args.steps, log_every=20)
    print(
        f"solved={result.solved} env_steps={result.env_steps} "
        f"episodes={result.episodes} window={result.final_window_mean:.1f} "
        f"wall={result.wall_time_s:.1f}s"
    )
    plot_history(result.history, f"{args.workdir}/curves.png")
    trainer.save_pickle_compat(f"{args.workdir}/ref_format")

    # greedy rollouts (ref: 10 rendered episodes, Test/lunar_lander.py:84-86)
    rets = []
    for i in range(args.rollouts):
        traj = record_trajectory(
            trainer.env,
            trainer.env_params,
            trainer.network,
            trainer.runner.train.params,
            jax.random.PRNGKey(1000 + i),
        )
        rets.append(traj["ret"])
        dump_trajectory(f"{args.workdir}/rollout_{i}.npz", traj)
        plot_lander_flight(traj, f"{args.workdir}/rollout_{i}.png")
    print(f"greedy rollout returns: mean={np.mean(rets):.1f} {['%.0f' % r for r in rets]}")


if __name__ == "__main__":
    main()
