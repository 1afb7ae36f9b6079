"""Cross-engine policy transfer: evaluate trained lander policies on BOTH
the pure-JAX env and gymnasium's Box2D env.

VERDICT r2 item 4: the 3/3-vs-1/3 solve asymmetry needed localizing — if a
policy trained on the JAX env scores the same when replayed on Box2D, the
envs present the same task; a gap isolates where the JAX env is easier or
harder.  Runs greedy (argmax) rollouts with the same network on:

  * the JAX env (jointed engine, VectorEnv greedy evaluator), and
  * Box2D via the host loop (one env, gymnasium API).

Usage (CPU; params from seed_robustness_population --save-params):

    JAX_PLATFORMS=cpu python examples/policy_transfer.py \
        --params-dir runs/ref_parity_params --preset lunar_ref_parity \
        --episodes 20 --out artifacts/policy_transfer.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--params-dir", required=True)
    ap.add_argument("--preset", default="lunar_ref_parity")
    ap.add_argument("--episodes", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="artifacts/policy_transfer.json")
    ap.add_argument("--set", action="append", default=[], metavar="FIELD=VALUE")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from deep_q_learning_tpu.__main__ import build_config
    from deep_q_learning_tpu.algos.evaluate import build_evaluator
    from deep_q_learning_tpu.compat.host_env import make_host_env
    from deep_q_learning_tpu.envs import VectorEnv, make_env
    from deep_q_learning_tpu.models import QNetwork

    cfg = build_config(args.preset, args.set)
    env, env_params = make_env(
        cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode,
        param_overrides=cfg.env_param_overrides(),
    )
    net = QNetwork(num_actions=env.num_actions, hidden=cfg.hidden, dueling=cfg.dueling)
    venv = VectorEnv(env, args.episodes)
    evaluator = jax.jit(
        build_evaluator(venv, env_params, net, env_params.max_steps_in_episode)
    )

    genv, obs_dim, _ = make_host_env(
        "box2d",
        env_id=cfg.env_id,
        max_steps=cfg.max_steps_in_episode or 1000,
        time_fraction=cfg.time_fraction_obs,
        seed=args.seed,
    )

    @jax.jit
    def act(params, obs):
        return jnp.argmax(net.apply(params, obs[None]), axis=-1)[0]

    results = []
    for path in sorted(glob.glob(os.path.join(args.params_dir, "member_*.pickle"))):
        with open(path, "rb") as f:
            params = pickle.load(f)
        jax_rets, _, _ = evaluator(params, jax.random.PRNGKey(args.seed))
        jax_rets = np.asarray(jax_rets)

        box_rets = []
        max_steps = cfg.max_steps_in_episode or 1000
        for ep in range(args.episodes):
            obs, _ = genv.reset(seed=args.seed * 10_000 + ep)
            ret = 0.0
            # the host env is unwrapped: truncation is the caller's job,
            # exactly as in the reference (q_agent.py:179-180)
            for _ in range(max_steps):
                a = int(act(params, jnp.asarray(np.asarray(obs, np.float32))))
                obs, r, term, trunc, _ = genv.step(a)
                ret += float(r)
                if term or trunc:
                    break
            box_rets.append(ret)
        results.append(
            {
                "member": os.path.basename(path),
                "jax_eval_mean": round(float(jax_rets.mean()), 2),
                "jax_land_rate": round(float((jax_rets > 200).mean()), 2),
                "box2d_eval_mean": round(float(np.mean(box_rets)), 2),
                "box2d_land_rate": round(float(np.mean([r > 200 for r in box_rets])), 2),
                "jax_returns": [round(float(r), 1) for r in jax_rets],
                "box2d_returns": [round(r, 1) for r in box_rets],
            }
        )
        print(json.dumps({k: results[-1][k] for k in
                          ("member", "jax_eval_mean", "box2d_eval_mean",
                           "jax_land_rate", "box2d_land_rate")}), flush=True)

    summary = {
        "preset": args.preset,
        "episodes_per_engine": args.episodes,
        "members": results,
        "mean_gap_jax_minus_box2d": round(
            float(
                np.mean([m["jax_eval_mean"] for m in results])
                - np.mean([m["box2d_eval_mean"] for m in results])
            ),
            2,
        ),
    }
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
