"""Benchmark: aggregate env-steps/s with full training enabled, on one GPU.

    python bench.py                  # the four configurations below
    python bench.py --mesh [N ...]   # weak scaling over N cards (default 1 2 4)
    python bench.py --mesh --lunar   # ... of the physics+PER program

Every counted env step comes from the full actor + replay + learner
superstep (``algos/superstep.py``) built through ``build_superstep``.
Configurations, run in this order in one process:

* ``cartpole@131072``: BASELINE.json config 2 (CartPole vanilla DQN,
  batch 512, learner every frame) at 131072 envs; the headline ``value``;
* ``lunar_per@1024``: ``lunar_per_scaled(1024)``, the rigid lander with
  dueling double DQN and prioritized n-step replay;
* ``lunar_jointed@1024`` and ``lunar_jointed@4096``:
  ``lunar_jointed_scaled``, the same learner on the jointed 3-body lander.

Each configuration compiles (set-up, reported as ``compile_s``), warms for
4 supersteps so replay passes ``training_start``, then takes the best of 3
windows of 30 supersteps, each timed against a host fetch of the last
superstep's metrics.  A configuration that fails raises; there is no
fallback.  The last line of output is one JSON object that names the
platform, device kind, device count and the card's power limit.
"""

import dataclasses
import json
import sys
import time

CELLS = (
    ("cartpole", 131072),
    ("lunar", 1024),
    ("lunar_jointed", 1024),
    ("lunar_jointed", 4096),
)


def bench_config(preset: str, num_envs: int):
    from deep_q_learning_tpu.config import (
        cartpole_vector,
        lunar_jointed_scaled,
        lunar_per_scaled,
    )

    if preset == "lunar":
        return lunar_per_scaled(num_envs)
    if preset == "lunar_jointed":
        return lunar_jointed_scaled(num_envs)
    return dataclasses.replace(
        cartpole_vector(),
        num_envs=num_envs,
        buffer_capacity=max(1 << 20, num_envs * 64),
    )


def run_bench(num_envs: int, preset: str = "cartpole") -> dict:
    import jax

    from deep_q_learning_tpu.algos import build_superstep, make_optimizer
    from deep_q_learning_tpu.envs import VectorEnv, make_env
    from deep_q_learning_tpu.models import QNetwork
    from deep_q_learning_tpu.replay import make_replay

    cfg = bench_config(preset, num_envs)
    env, p = make_env(
        cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode,
        param_overrides=cfg.env_param_overrides(),
    )
    net = QNetwork(num_actions=env.num_actions, hidden=cfg.hidden, dueling=cfg.dueling)
    init_runner, superstep = build_superstep(
        VectorEnv(env, cfg.num_envs), p, net, make_optimizer(cfg), make_replay(cfg), cfg
    )
    runner = jax.jit(init_runner)(jax.random.PRNGKey(0))
    t0 = time.perf_counter()
    step = jax.jit(superstep, donate_argnums=0).lower(runner).compile()
    compile_s = time.perf_counter() - t0

    for _ in range(4):  # fill replay past training_start: the learner runs
        runner, m = step(runner)
    float(m.window_mean)

    steps_per_call = cfg.steps_per_superstep * cfg.num_envs
    best = 0.0
    for _ in range(3):
        n = 30
        t0 = time.perf_counter()
        for _ in range(n):
            runner, m = step(runner)
        float(m.window_mean)  # host fetch: the window ends when the device does
        best = max(best, n * steps_per_call / (time.perf_counter() - t0))
    return {
        "value": best,
        "num_envs": num_envs,
        "preset": preset,
        "compile_s": round(compile_s, 1),
    }


# ---------------------------------------------------------------------------
# mesh weak-scaling harness (bench.py --mesh [N ...])
# ---------------------------------------------------------------------------

_MESH_ENVS_PER_SHARD = 2048  # fixed per-shard work => weak scaling


def run_mesh_bench(n_shards: int, preset: str = "cartpole") -> dict:
    """Measure the distributed superstep on the first ``n_shards`` devices,
    with a fixed env count per shard."""
    import jax

    from deep_q_learning_tpu.config import cartpole_vector, lunar_per
    from deep_q_learning_tpu.parallel import make_env_mesh
    from deep_q_learning_tpu.parallel.distributed import build_distributed_superstep

    if jax.device_count() < n_shards:
        raise RuntimeError(f"{jax.device_count()} devices < {n_shards} shards")
    mesh = make_env_mesh(n_shards)
    base = lunar_per() if preset == "lunar" else cartpole_vector()
    cfg = dataclasses.replace(
        base,
        num_envs=_MESH_ENVS_PER_SHARD * n_shards,
        batch_size=max(base.batch_size, 8 * n_shards),
        buffer_capacity=max(1 << 17, _MESH_ENVS_PER_SHARD * n_shards * 32),
    )
    init_runner, superstep, _ = build_distributed_superstep(cfg, mesh)
    runner = init_runner(jax.random.PRNGKey(0))
    step = jax.jit(superstep, donate_argnums=0)

    for _ in range(3):  # compile + buffer fill
        runner, m = step(runner)
    float(m.window_mean)

    steps_per_call = cfg.steps_per_superstep * cfg.num_envs
    best = 0.0
    for _ in range(3):
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            runner, m = step(runner)
        float(m.window_mean)
        best = max(best, n * steps_per_call / (time.perf_counter() - t0))
    return {
        "n_shards": n_shards,
        "envs_per_shard": _MESH_ENVS_PER_SHARD,
        "aggregate_steps_per_s": round(best),
        "per_shard_steps_per_s": round(best / n_shards),
    }


def device_fields() -> dict:
    import jax

    from deep_q_learning_tpu.utils.metrics import gpu_cards

    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": jax.device_count(),
        "power_limit": gpu_cards()[0].split(",")[-1].strip(),
    }


def main() -> int:
    import jax

    from deep_q_learning_tpu.utils.compile_cache import enable_compile_cache

    if jax.default_backend() != "gpu":
        print(f"bench: needs a GPU; JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    argv = sys.argv[1:]
    if argv and argv[0] == "--mesh":
        counts = [int(x) for x in argv[1:] if not x.startswith("--")] or [1, 2, 4]
        preset = "lunar" if "--lunar" in argv else "cartpole"
        results = [run_mesh_bench(n, preset) for n in counts]
        base = next((r for r in results if r["n_shards"] == 1), None)
        for r in results:
            if base:
                r["efficiency_vs_1"] = round(
                    r["aggregate_steps_per_s"]
                    / (r["n_shards"] * base["aggregate_steps_per_s"]), 3)
        print(json.dumps({"metric": "mesh_weak_scaling", "preset": preset,
                          "results": results, **device_fields()}))
        return 0

    cells = {}
    for preset, num_envs in CELLS:
        r = run_bench(num_envs, preset)
        cells[f"{preset}@{num_envs}"] = r
        print(json.dumps(r), flush=True)
    head = cells["cartpole@131072"]
    print(json.dumps({
        "metric": "env_steps_per_s_training_on",
        "value": round(head["value"]),
        "unit": "env-steps/s",
        "num_envs": head["num_envs"],
        "lunar_per_1024envs_env_steps_per_s": round(cells["lunar@1024"]["value"]),
        "lunar_jointed_1024envs_env_steps_per_s": round(
            cells["lunar_jointed@1024"]["value"]),
        "lunar_jointed_4096envs_env_steps_per_s": round(
            cells["lunar_jointed@4096"]["value"]),
        "compile_s": {k: v["compile_s"] for k, v in cells.items()},
        **device_fields(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
