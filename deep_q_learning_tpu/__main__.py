"""Command-line interface: ``python -m deep_q_learning_tpu <cmd>``.

The reference's entry layer is two ``__main__`` scripts with hard-coded
constants (``/root/reference/Test/lunar_lander.py:23-37``,
``Test/lunar_lander_hyper_params.py:22-30``).  Here the same surface is a
CLI over the typed presets (``config.PRESETS``): any ``DQNConfig`` field can
be overridden from the command line with ``--set key=value``, so experiment
configs are reproducible shell lines instead of code edits.

Commands:
  presets                      list the built-in presets
  train --preset P [...]       train (optionally distributed over the mesh)
  eval --preset P --workdir D  greedy-evaluate a saved checkpoint
  hpo --preset P [...]         Bayesian hyperparameter search (GP-UCB)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import typing
from typing import Any, Dict, List, Optional

from deep_q_learning_tpu.config import DQNConfig, PRESETS


def _coerce(field: dataclasses.Field, raw: str) -> Any:
    """Parse a CLI string into the type of a DQNConfig field."""
    t = field.type
    if isinstance(t, str):  # from __future__ annotations: resolve by name
        t = typing.get_type_hints(DQNConfig)[field.name]
    origin = typing.get_origin(t)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(t) if a is not type(None)]
        if raw.lower() in ("none", "null"):
            return None
        t = args[0]
        origin = typing.get_origin(t)
    if origin in (tuple, typing.Tuple):
        inner = typing.get_args(t)[0]
        return tuple(inner(x) for x in raw.split(",") if x)
    if t is bool:
        if raw.lower() in ("1", "true", "yes", "on"):
            return True
        if raw.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"not a bool: {raw!r}")
    return t(raw)


def build_config(preset: str, overrides: List[str]) -> DQNConfig:
    """Preset + ``key=value`` override strings -> frozen DQNConfig."""
    if preset not in PRESETS:
        raise SystemExit(
            f"unknown preset {preset!r}; available: {', '.join(sorted(PRESETS))}"
        )
    cfg = PRESETS[preset]()
    fields = {f.name: f for f in dataclasses.fields(DQNConfig)}
    kv: Dict[str, Any] = {}
    for item in overrides:
        if "=" not in item:
            raise SystemExit(f"--set expects key=value, got {item!r}")
        key, _, raw = item.partition("=")
        key = key.strip()
        if key not in fields:
            raise SystemExit(
                f"unknown config field {key!r}; see `python -m "
                f"deep_q_learning_tpu presets --fields`"
            )
        try:
            kv[key] = _coerce(fields[key], raw.strip())
        except (TypeError, ValueError) as e:
            raise SystemExit(f"bad value for {key}: {e}")
    return dataclasses.replace(cfg, **kv)


# ------------------------------------------------------------------ commands

def cmd_presets(args: argparse.Namespace) -> int:
    for name, factory in PRESETS.items():
        doc = (factory.__doc__ or "").strip().splitlines()[0]
        print(f"{name:22s} {doc}")
    if args.fields:
        print("\nconfig fields (override with --set key=value):")
        for f in dataclasses.fields(DQNConfig):
            print(f"  {f.name:24s} default={f.default!r}")
    return 0


def cmd_train(args: argparse.Namespace) -> int:
    cfg = build_config(args.preset, args.set or [])
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.resume and not args.workdir:
        raise SystemExit("--resume requires --workdir (where the checkpoints live)")
    if args.distributed:
        from deep_q_learning_tpu.train import DistributedTrainer

        trainer = DistributedTrainer(cfg, workdir=args.workdir).init()
        if args.resume:
            trainer.restore()  # latest mesh-consistent checkpoint (SURVEY §5.3)
        result = trainer.train(
            max_env_steps=args.max_env_steps,
            log_every=args.log_every,
            checkpoint_every=args.checkpoint_every,
            verbose=not args.quiet,
        )
    else:
        from deep_q_learning_tpu.train import Trainer

        trainer = Trainer(cfg, workdir=args.workdir).init()
        if args.resume:
            trainer.restore()  # latest checkpoint in workdir (true resume:
            # params, opt state, buffer, RNG, counters — SURVEY §5.4 fix)
        result = trainer.train(
            max_env_steps=args.max_env_steps,
            log_every=args.log_every,
            checkpoint_every=args.checkpoint_every,
            eval_every=args.eval_every,
            verbose=not args.quiet,
        )
    summary = {
        "solved": result.solved,
        "env_steps": result.env_steps,
        "episodes": result.episodes,
        "wall_time_s": round(result.wall_time_s, 2),
        "final_window_mean": round(result.final_window_mean, 3),
    }
    print(json.dumps(summary))
    if args.history_out:
        with open(args.history_out, "w") as f:
            for rec in result.history:
                f.write(json.dumps(rec) + "\n")
    return 0


def cmd_eval(args: argparse.Namespace) -> int:
    import numpy as np

    from deep_q_learning_tpu.train import Trainer

    cfg = build_config(args.preset, args.set or [])
    trainer = Trainer(cfg, workdir=args.workdir)
    trainer.restore(step=args.step)
    ev = trainer.evaluate(seed=args.seed if args.seed is not None else 0)
    rets, lengths = ev.returns, ev.lengths
    print(
        json.dumps(
            {
                "episodes": int(rets.shape[0]),
                "return_mean": float(np.mean(rets)),
                "return_std": float(np.std(rets)),
                "length_mean": float(np.mean(lengths)),
            }
        )
    )
    if args.rollout_dir:
        # the reference's post-training phase: greedy rollouts from the
        # loaded checkpoint (Test/lunar_lander.py:80-86; render -> .npz+PNG)
        import os

        import jax

        from deep_q_learning_tpu.utils.visualize import (
            dump_trajectory,
            lander_pose_extras,
            lander_static,
            plot_lander_flight,
            record_trajectory,
            render_lander_animation,
        )

        is_lander = cfg.env_id.startswith("LunarLander")
        os.makedirs(args.rollout_dir, exist_ok=True)
        for i in range(args.rollouts):
            traj = record_trajectory(
                trainer.env,
                trainer.env_params,
                trainer.network,
                trainer.runner.train.params,
                jax.random.PRNGKey(1000 + i),
                extras_fn=lander_pose_extras if is_lander else None,
                static_fn=lander_static if is_lander else None,
            )
            dump_trajectory(f"{args.rollout_dir}/rollout_{i}.npz", traj)
            if is_lander:
                plot_lander_flight(traj, f"{args.rollout_dir}/rollout_{i}.png")
                if args.render:
                    # animated replay (the reference's env.render() window,
                    # utils.py:43-52, as a headless .gif/.mp4)
                    out = render_lander_animation(
                        traj, f"{args.rollout_dir}/rollout_{i}.{args.render}"
                    )
                    print(f"rollout {i}: wrote {out}")
            print(f"rollout {i}: return={traj['ret']:.1f} length={traj['length']}")
    return 0


def cmd_hpo(args: argparse.Namespace) -> int:
    from deep_q_learning_tpu.hpo.bayesopt import (
        SPACES,
        make_dqn_objective,
        optimize,
    )

    cfg = build_config(args.preset, args.set or [])
    space = SPACES[args.space]
    if args.population > 1:
        import dataclasses as _dc

        from deep_q_learning_tpu.hpo.bayesopt import (
            make_population_objective,
            optimize_batched,
        )

        result = optimize_batched(
            make_population_objective(
                cfg,
                env_steps_per_trial=args.steps_per_trial,
                train_seed=args.seed if args.seed is not None else 0,
            ),
            space=space,
            num_trials=args.trials,
            batch_q=args.population,
            seed=args.seed if args.seed is not None else 1000,
            verbose=not args.quiet,
        )
    else:
        objective = make_dqn_objective(
            cfg,
            env_steps_per_trial=args.steps_per_trial,
            train_seed=args.seed,
        )
        result = optimize(
            objective,
            space=space,
            num_trials=args.trials,
            seed=args.seed if args.seed is not None else 1000,
            verbose=not args.quiet,
        )
    print(
        json.dumps(
            {"best_objective": result.best_objective, "best_params": result.best_params}
        )
    )
    if args.history_out:
        with open(args.history_out, "w") as f:
            for t in result.trials:
                f.write(json.dumps({"objective": t.objective, "params": t.params}) + "\n")
    return 0


# --------------------------------------------------------------------- main

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deep_q_learning_tpu", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("presets", help="list built-in presets")
    p.add_argument("--fields", action="store_true", help="also list config fields")
    p.set_defaults(fn=cmd_presets)

    def common(p: argparse.ArgumentParser) -> None:
        p.add_argument("--preset", required=True, choices=sorted(PRESETS))
        p.add_argument(
            "--set", action="append", metavar="KEY=VALUE",
            help="override any DQNConfig field (repeatable)",
        )
        p.add_argument("--seed", type=int, default=None)
        p.add_argument("--quiet", action="store_true")

    p = sub.add_parser("train", help="train a preset")
    common(p)
    p.add_argument("--max-env-steps", type=int, default=10_000_000)
    p.add_argument("--workdir", type=str, default=None)
    p.add_argument("--log-every", type=int, default=10, metavar="SUPERSTEPS")
    p.add_argument("--checkpoint-every", type=int, default=None, metavar="SUPERSTEPS")
    p.add_argument("--eval-every", type=int, default=None, metavar="SUPERSTEPS")
    p.add_argument(
        "--distributed", action="store_true",
        help="shard envs over all visible devices (replicated learner, "
        "gradient all-reduce across devices)",
    )
    p.add_argument("--history-out", type=str, default=None, metavar="JSONL")
    p.add_argument(
        "--resume", action="store_true",
        help="restore the latest checkpoint in --workdir before training",
    )
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="greedy-evaluate a checkpoint")
    common(p)
    p.add_argument("--workdir", type=str, required=True)
    p.add_argument("--step", type=int, default=None, help="checkpoint step (default latest)")
    p.add_argument(
        "--rollout-dir", type=str, default=None,
        help="also record greedy rollouts here (.npz + flight PNGs)",
    )
    p.add_argument("--rollouts", type=int, default=10)  # ref renders 10
    p.add_argument(
        "--render", choices=("gif", "mp4"), default=None,
        help="write an animated replay per rollout (headless equivalent of "
        "the reference's live render window)",
    )
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("hpo", help="Bayesian hyperparameter search")
    common(p)
    p.add_argument("--trials", type=int, default=20)  # ref: 20 runs
    p.add_argument(
        "--space",
        choices=("reference", "lunar"),
        default="reference",
        help="search space: the reference's exact bounds, or the runtime-only "
        "lunar space (one compiled program for the whole search)",
    )
    p.add_argument("--steps-per-trial", type=int, default=2_000_000)
    p.add_argument(
        "--population", type=int, default=1, metavar="Q",
        help="evaluate Q candidates per GP round as ONE vmapped population "
        "(candidates sharing static fields train concurrently on device)",
    )
    p.add_argument("--history-out", type=str, default=None, metavar="JSONL")
    p.set_defaults(fn=cmd_hpo)

    args = ap.parse_args(argv)
    from deep_q_learning_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
