"""Multi-process (multi-host-shaped) distributed execution tests.

SURVEY.md §4.3 prescribes testing multi-host logic via a process-spawning
fixture; BASELINE config 5 is "envs sharded over 2+ hosts".  These tests
launch 2 REAL OS processes (x 4 virtual CPU devices each), joined by
``jax.distributed.initialize`` into one 8-device runtime — the same process
topology as one-process-per-host on a pod slice — and verify, cross-process:

  * the global mesh spans both processes and training runs;
  * the replicated learner is BIT-IDENTICAL across processes after training
    (gradient psum over Gloo here, NCCL on GPUs);
  * checkpointing works with >1 process (sharded leaves gathered, one
    writer), restores bitwise, and
    a resumed superstep is deterministic;
  * metric aggregation is correct when each process only addresses its own
    shards (metrics are psum-reduced in-graph and replicated out).
"""

import json
import os
import socket
import subprocess
import sys

import pytest

NPROC = 2
LOCAL_DEVICES = 4
_WORKER = os.path.join(os.path.dirname(__file__), "_mp_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mp_results(tmp_path_factory):
    """Spawn the 2-process worker fleet once; yield their JSON digests."""
    outdir = str(tmp_path_factory.mktemp("mp"))
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), str(NPROC), str(port),
             str(LOCAL_DEVICES), outdir],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(NPROC)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed (rc={p.returncode}):\n{out}"
    results = []
    for i in range(NPROC):
        with open(os.path.join(outdir, f"result_{i}.json")) as f:
            results.append(json.load(f))
    return results


def test_global_runtime_spans_processes(mp_results):
    for r in mp_results:
        assert r["process_count"] == NPROC
        assert r["device_count"] == NPROC * LOCAL_DEVICES
        assert r["local_device_count"] == LOCAL_DEVICES


def test_learner_replicated_across_processes(mp_results):
    """Every process's copy of the learner params hashes identically after
    training — the replicated-learner invariant holds CROSS-PROCESS, not just
    across the shards one process can see."""
    digests = {r["post_train_digest"] for r in mp_results}
    assert len(digests) == 1, f"learner diverged across processes: {digests}"


def test_multiprocess_checkpoint_restore_bitwise(mp_results):
    """Multi-process save -> restore reproduces the saved learner
    exactly, identically on both processes, and repeatably."""
    for r in mp_results:
        assert r["restored_digest"] == r["post_train_digest"]
        assert r["restored_digest_repeat"] == r["restored_digest"]
    assert len({r["restored_digest"] for r in mp_results}) == 1


def test_multiprocess_resume_deterministic(mp_results):
    """A superstep resumed from the checkpoint is bitwise deterministic
    (same digest on repeat) and identical across processes."""
    for r in mp_results:
        assert r["resumed_digest"] == r["resumed_digest_repeat"]
        assert r["resumed_metrics"] == r["resumed_metrics_repeat"]
    assert len({r["resumed_digest"] for r in mp_results}) == 1
    aggs = [r["resumed_metrics"] for r in mp_results]
    assert aggs[0] == aggs[1]


def test_multiprocess_metrics_aggregate(mp_results):
    """Aggregated metrics are globally correct from every process: env-step
    accounting matches the lockstep vector-step math, and episode counts are
    the global psum (identical on both processes)."""
    for r in mp_results:
        assert r["train_env_steps"] >= 4 * 8 * 8 * NPROC * LOCAL_DEVICES
        assert r["train_episodes"] > 0
        m = r["resumed_metrics"]
        assert m["env_steps"] > 0 and m["env_steps"] % (8 * NPROC * LOCAL_DEVICES * 8) == 0
        assert 0.0 <= m["epsilon"] <= 1.0
    assert mp_results[0]["train_episodes"] == mp_results[1]["train_episodes"]
