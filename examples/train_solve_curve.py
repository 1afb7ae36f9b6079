"""Train a preset and record its solve curve as a durable artifact.

The round-3 solve artifacts (artifacts/lunar_per_scaled_solve.json) were
produced by ad-hoc scripts; this is the committed harness.  Trains the
preset until solved or the step budget runs out, then runs TRUE greedy
evaluation (the reference's eval returned the training window,
``/root/reference/General/QLearning/q_agent.py:231``) and writes
``artifacts/<preset>_solve.json`` with the full window curve.

Usage (on the GPU):
    python examples/train_solve_curve.py lunar_jointed_per \
        [--steps 60000000] [--seed 0] [--set key=value ...]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from deep_q_learning_tpu.__main__ import build_config
from deep_q_learning_tpu.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("preset")
    ap.add_argument("--steps", type=int, default=60_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--set", nargs="*", default=[])
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    cfg = build_config(args.preset, args.set)
    tr = Trainer(cfg)
    tr.init(seed=args.seed)
    t0 = time.time()
    res = tr.train(max_env_steps=args.steps, log_every=args.log_every, verbose=True)
    rets, lengths, _trunc = tr.evaluate(seed=12345)
    solved_at = None
    best_window = -np.inf
    for rec in res.history:
        best_window = max(best_window, rec["window_mean"])
        if solved_at is None and cfg.solve_threshold is not None and (
            rec["window_mean"] >= cfg.solve_threshold
        ):
            solved_at = rec["env_steps"]
    out = {
        "preset": args.preset,
        "overrides": args.set,
        "seed": args.seed,
        "solved": bool(res.solved),
        "wall_s": round(time.time() - t0, 1),
        "best_window": round(float(best_window), 1),
        "solved_at_env_steps": solved_at,
        "final_env_steps": res.env_steps,
        "greedy_eval_mean": round(float(np.mean(rets)), 1),
        "greedy_eval_std": round(float(np.std(rets)), 1),
        "eval_episode_len_mean": round(float(np.mean(lengths)), 1),
        "curve": [
            {"env_steps": r["env_steps"], "window": round(r["window_mean"], 1)}
            for r in res.history
        ],
    }
    path = args.out or os.path.join(REPO, "artifacts", f"{args.preset}_solve.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "curve"}))


if __name__ == "__main__":
    main()
