"""Multi-card / multi-host DDQN (BASELINE config 5): env instances sharded
over the ("env",) device mesh, replicated learner, gradient all-reduce.  On
a cluster, launch one process per host (each calls
``jax.distributed.initialize`` via ``distributed_init``); on one host it uses
every local device; under ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
it runs on a virtual CPU mesh for validation.

Single-process (one host / virtual mesh):
    python examples/train_multihost.py [--steps 20000000]

Explicit multi-process (2+ real OS processes joined into one runtime — the
process topology of a multi-host cluster; works on the CPU backend too,
collectives ride Gloo instead of NCCL).  Launch one command per process:
    python examples/train_multihost.py --coordinator localhost:12345 \
        --num-processes 2 --process-id 0 --local-devices 4 --cpu &
    python examples/train_multihost.py --coordinator localhost:12345 \
        --num-processes 2 --process-id 1 --local-devices 4 --cpu &
"""

import argparse
import dataclasses
import os


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (multi-process launch)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--local-devices", type=int, default=None,
                    help="virtual CPU devices per process (CPU validation)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    ap.add_argument("--workdir", default=None, help="checkpoint directory")
    args = ap.parse_args()

    if args.local_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.local_devices}"
        )
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from deep_q_learning_tpu.config import multihost_ddqn
    from deep_q_learning_tpu.parallel import distributed_init, make_env_mesh
    from deep_q_learning_tpu.train import DistributedTrainer

    distributed_init(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    mesh = make_env_mesh()
    n = mesh.devices.size
    cfg = dataclasses.replace(
        multihost_ddqn(),
        seed=args.seed,
        # keep per-shard sizes sane on any mesh size
        num_envs=max(1024, 128 * n) // n * n,
        batch_size=max(256, 32 * n) // n * n,
    )
    is_main = jax.process_index() == 0
    if is_main:
        print(
            f"mesh: {n} devices over {jax.process_count()} process(es); "
            f"{cfg.num_envs} envs ({cfg.num_envs // n}/shard)"
        )
    trainer = DistributedTrainer(cfg, mesh=mesh, workdir=args.workdir).init()
    result = trainer.train(max_env_steps=args.steps, log_every=10, verbose=is_main)
    if args.workdir:
        trainer.save(step=result.env_steps)
    if is_main:
        print(
            f"solved={result.solved} env_steps={result.env_steps} "
            f"window={result.final_window_mean:.1f} wall={result.wall_time_s:.1f}s"
        )


if __name__ == "__main__":
    main()
