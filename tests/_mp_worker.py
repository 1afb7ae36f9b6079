"""Worker process for the multi-process distributed tests.

Launched by ``tests/test_multiprocess.py`` as N real OS processes, each with
its own virtual CPU devices (``--xla_force_host_platform_device_count``),
joined into ONE jax runtime via ``jax.distributed.initialize`` — the same
process topology as one process per host on a multi-host cluster (SURVEY.md §4.3:
"multi-host logic testable via ... a process-spawning pytest fixture").

Each worker trains a ``DistributedTrainer`` over the GLOBAL mesh, saves a
multi-process checkpoint, restores it (twice), resumes, and writes a
JSON digest of everything the test needs to verify:
  * the replicated learner is bit-identical across processes,
  * save/restore round-trips with >1 process,
  * metrics aggregate correctly when each process only addresses its shards,
  * resume-from-checkpoint is bitwise deterministic.

Usage: python tests/_mp_worker.py <process_id> <num_processes> <port> \
           <local_devices> <outdir>
"""

import hashlib
import json
import os
import sys


def digest_tree(tree) -> str:
    """Order-stable sha256 over every leaf's process-local replicated value.

    Learner leaves are replicated over the mesh, so shard 0's data is the
    whole (global) array on every process — identical digests across
    processes prove the replicated-learner invariant cross-host."""
    import jax
    import numpy as np

    h = hashlib.sha256()
    leaves, _ = jax.tree.flatten(tree)
    for leaf in leaves:
        arr = np.asarray(leaf.addressable_shards[0].data)
        h.update(arr.tobytes())
    return h.hexdigest()


def main() -> None:
    pid, nproc, port, local_devices = map(int, sys.argv[1:5])
    outdir = sys.argv[5]

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={local_devices}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")

    from deep_q_learning_tpu.parallel import distributed_init

    distributed_init(
        coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == nproc * local_devices
    assert jax.local_device_count() == local_devices

    import numpy as np

    from deep_q_learning_tpu.config import DQNConfig
    from deep_q_learning_tpu.parallel import aggregate_metrics, make_env_mesh
    from deep_q_learning_tpu.train import DistributedTrainer

    cfg = DQNConfig(
        env_id="CartPole-v1",
        num_envs=8 * nproc * local_devices,
        steps_per_superstep=8,
        batch_size=8 * nproc * local_devices,
        training_start=128,
        buffer_capacity=4096,
        double=False,
        dueling=False,
        hidden=(32, 32),
        learning_rate=5e-4,
        eps_schedule="linear_step",
        train_every=1,
        target_sync_mode="steps",
        target_sync_every=64,
        return_window=16,
    )
    mesh = make_env_mesh()  # global: spans every process
    wd = os.path.join(outdir, "ckpt")

    tr = DistributedTrainer(cfg, mesh=mesh, workdir=wd).init(seed=7)
    res = tr.train(max_env_steps=4 * cfg.steps_per_superstep * cfg.num_envs,
                   log_every=1, verbose=False)
    post_train_digest = digest_tree(tr.runner.train.params)
    tr.save(step=res.env_steps)

    def restore_and_step():
        t2 = DistributedTrainer(cfg, mesh=mesh, workdir=wd).init(seed=99)
        t2.restore(step=res.env_steps)
        restored_digest = digest_tree(t2.runner.train.params)
        t2.runner, m = t2._superstep(t2.runner)
        return restored_digest, digest_tree(t2.runner.train.params), aggregate_metrics(m, cfg)

    restored1, resumed1, agg1 = restore_and_step()
    restored2, resumed2, agg2 = restore_and_step()

    result = {
        "process_id": pid,
        "process_count": jax.process_count(),
        "device_count": jax.device_count(),
        "local_device_count": jax.local_device_count(),
        "train_env_steps": res.env_steps,
        "train_episodes": res.episodes,
        "history_last": res.history[-1] if res.history else None,
        "post_train_digest": post_train_digest,
        "restored_digest": restored1,
        "restored_digest_repeat": restored2,
        "resumed_digest": resumed1,
        "resumed_digest_repeat": resumed2,
        "resumed_metrics": agg1,
        "resumed_metrics_repeat": agg2,
    }
    with open(os.path.join(outdir, f"result_{pid}.json"), "w") as f:
        json.dump(result, f, indent=1, default=float)
    print(f"[p{pid}] OK", flush=True)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
