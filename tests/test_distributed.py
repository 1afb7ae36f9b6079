"""Mesh-sharding tests on the virtual 8-device CPU mesh (conftest sets
``--xla_force_host_platform_device_count=8``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deep_q_learning_tpu.config import DQNConfig
from deep_q_learning_tpu.parallel import (
    ENV_AXIS,
    aggregate_metrics,
    build_distributed_superstep,
    make_env_mesh,
)

CFG = DQNConfig(
    env_id="CartPole-v1",
    num_envs=64,
    steps_per_superstep=8,
    batch_size=64,
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


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_env_mesh(8)


def test_runs_and_aggregates(mesh8):
    init_runner, superstep, _ = build_distributed_superstep(CFG, mesh8)
    runner = init_runner(jax.random.PRNGKey(0))
    step = jax.jit(superstep, donate_argnums=0)
    for _ in range(6):
        runner, m = step(runner)
    agg = aggregate_metrics(m, CFG, 8)
    assert agg["env_steps"] == 6 * CFG.steps_per_superstep * CFG.num_envs
    assert agg["episodes"] > 0
    assert np.isfinite(agg["loss"]) and agg["loss"] > 0  # learner ran
    assert 0 <= agg["epsilon"] <= 1


def test_learner_stays_replicated(mesh8):
    """After training with per-shard batches + pmean'd grads, every device
    must hold bit-identical learner params (the replicated-learner invariant,
    SURVEY.md §5.8)."""
    init_runner, superstep, _ = build_distributed_superstep(CFG, mesh8)
    runner = init_runner(jax.random.PRNGKey(1))
    step = jax.jit(superstep, donate_argnums=0)
    for _ in range(4):
        runner, m = step(runner)
    assert float(np.sum(np.asarray(m.loss_count))) > 0, "no updates ran"
    for leaf in jax.tree.leaves(runner.train.params):
        shards = [np.asarray(s.data) for s in leaf.addressable_shards]
        for s in shards[1:]:
            np.testing.assert_array_equal(shards[0], s)


def test_env_state_is_sharded(mesh8):
    init_runner, superstep, _ = build_distributed_superstep(CFG, mesh8)
    runner = init_runner(jax.random.PRNGKey(2))
    spec = runner.obs.sharding.spec
    assert spec == jax.sharding.PartitionSpec(ENV_AXIS)
    # replay storage sharded on env axis too (slot-major: env axis is dim 1)
    spec_r = runner.replay.storage.obs.sharding.spec
    assert spec_r[1] == ENV_AXIS
    # shards hold DIFFERENT env states (different reset keys per shard)
    shards = [np.asarray(s.data) for s in runner.obs.addressable_shards]
    assert not np.allclose(shards[0], shards[1])


def test_mesh_size_validation(mesh8):
    bad = dataclasses.replace(CFG, num_envs=63)
    with pytest.raises(ValueError):
        build_distributed_superstep(bad, mesh8)
    bad2 = dataclasses.replace(CFG, batch_size=4)
    with pytest.raises(ValueError):
        build_distributed_superstep(bad2, mesh8)


def test_graft_dryrun():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_flagship_jointed_per_pallas_in_mesh(mesh8):
    """The FLAGSHIP program under shard_map (VERDICT r4 missing #2): jointed
    3-body solver + prioritized n-step replay running distributed, with
    (a) the replicated-learner
    bitwise invariant, (b) PER state sharded on the env axis, and (c) PER's
    in-mesh sampling/update methods actually executing."""
    cfg = DQNConfig(
        env_id="LunarLander-v2",
        num_envs=32,
        steps_per_superstep=4,
        time_fraction_obs=True,
        max_steps_in_episode=64,
        replay="prioritized",
        n_step=3,
        batch_size=32,
        training_start=8,
        buffer_capacity=1024,
        hidden=(32, 32),
        eps_schedule="linear_step",
        train_every=1,
        target_tau=0.005,
        return_window=8,
        lander_engine="jointed",
        lander_vel_iters=30,  # tiny counts: physics correctness is gated
        lander_pos_iters=10,  # elsewhere; this tests the MESH program
    )
    init_runner, superstep, _ = build_distributed_superstep(cfg, mesh8)
    runner = init_runner(jax.random.PRNGKey(5))
    # PER priorities sharded over the env axis
    spec_p = runner.replay.priorities.sharding.spec
    assert spec_p[0] == ENV_AXIS, spec_p
    step = jax.jit(superstep, donate_argnums=0)
    for _ in range(4):
        runner, m = step(runner)
    assert float(np.sum(np.asarray(m.loss_count))) > 0, "learner never ran"
    assert np.isfinite(aggregate_metrics(m, cfg, 8)["loss"])
    # priorities were updated by the learner (not all at the init value)
    pri = np.asarray(jax.device_get(runner.replay.priorities))
    assert (pri > 0).any()
    assert len(np.unique(pri[pri > 0])) > 1, "PER priorities never updated"
    # replicated learner invariant holds with the full flagship program
    for leaf in jax.tree.leaves(runner.train.params):
        shards = [np.asarray(s.data) for s in leaf.addressable_shards]
        for s in shards[1:]:
            np.testing.assert_array_equal(shards[0], s)


def test_graft_entry_compiles():
    import __graft_entry__ as g

    fn, (params, obs) = g.entry()
    out = jax.jit(fn)(params, obs)
    assert out.shape == (obs.shape[0], 4)


def test_distributed_trainer(mesh8):
    from deep_q_learning_tpu.train import DistributedTrainer

    tr = DistributedTrainer(CFG, mesh=mesh8).init()
    res = tr.train(max_env_steps=2048, log_every=2, verbose=False)
    assert res.env_steps >= 2048
    assert res.episodes > 0
    assert np.isfinite(res.history[-1]["loss"])


def test_distributed_checkpoint_resume_bitwise(tmp_path, mesh8):
    """SURVEY §5.3-5.4 on the mesh path: DistributedTrainer saves the sharded
    runner and resumes bitwise — two independent restore+superstep runs from
    the same checkpoint produce identical learner params and metrics."""
    import os

    from deep_q_learning_tpu.train import DistributedTrainer

    wd = os.path.join(str(tmp_path), "dckpt")
    tr = DistributedTrainer(CFG, mesh=mesh8, workdir=wd).init()
    tr.train(max_env_steps=1024, log_every=2, verbose=False)
    tr.save(step=1)
    assert os.path.exists(os.path.join(wd, "config.json"))

    def continue_from_ckpt():
        t2 = DistributedTrainer(CFG, mesh=mesh8, workdir=wd).init()
        t2.restore(step=1)
        t2.runner, m = t2._superstep(t2.runner)
        return jax.tree.leaves(t2.runner.train.params), m

    leaves1, m1 = continue_from_ckpt()
    leaves2, m2 = continue_from_ckpt()
    for a, b in zip(leaves1, leaves2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    agg1 = aggregate_metrics(m1, CFG, 8)
    agg2 = aggregate_metrics(m2, CFG, 8)
    assert agg1 == agg2

    # config cross-check: a shape-affecting mismatch fails with a clear error
    bad_cfg = dataclasses.replace(CFG, hidden=(16, 16))
    with pytest.raises(ValueError, match="config mismatch"):
        DistributedTrainer(bad_cfg, mesh=mesh8, workdir=wd).init().restore(step=1)


def test_learner_stays_replicated_episodes_mode(mesh8):
    """Episodes-mode target sync must be a GLOBAL decision under the mesh
    (VERDICT r3 weak #3): the per-shard episode counters differ, so without
    the in-graph psum each shard would hard-copy target params at different
    steps and the replicated learner would silently desync."""
    cfg = dataclasses.replace(
        CFG, target_sync_mode="episodes", target_replace_episodes=4
    )
    init_runner, superstep, _ = build_distributed_superstep(cfg, mesh8)
    runner = init_runner(jax.random.PRNGKey(3))
    step = jax.jit(superstep, donate_argnums=0)
    for _ in range(6):
        runner, m = step(runner)
    assert int(np.asarray(m.episodes)) > 8, "no episodes completed"
    for name, tree in (
        ("params", runner.train.params),
        ("target_params", runner.train.target_params),
    ):
        for leaf in jax.tree.leaves(tree):
            shards = [np.asarray(s.data) for s in leaf.addressable_shards]
            for s in shards[1:]:
                np.testing.assert_array_equal(shards[0], s, err_msg=name)
    # the sync actually fired at least once: target caught up to online at
    # some point, so they can differ by at most the updates since last sync
    assert int(np.asarray(runner.last_sync_episodes).max()) > 0
