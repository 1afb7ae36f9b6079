"""``chip_smoke.py`` on the CPU: its phase functions at tiny sizes, and its
refusal to report success without a GPU.  Also the compile-cache placement
and a run with Flax and Orbax unimportable."""

import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import pytest

import chip_smoke as cs
from deep_q_learning_tpu.config import lunar_jointed_scaled, multihost_ddqn

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]


def _run(code: str, env_extra=None, cwd=_REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_main_refuses_cpu(capsys):
    assert cs.main([]) != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("b,a,double", [(64, 4, True), (50, 3, False)])
def test_td_loss_phase(b, a, double, cpu):
    assert cs.check_td_loss(cpu, b, a, double) < 1e-5


def test_qnet_forward_phase(cpu):
    hi, lo, lo_ok = cs.qnet_forward_errors(cpu, batch=32, hidden=(32, 32))
    assert hi <= 1e-5 and lo_ok


def test_exact_write_phases(cpu):
    assert cs.check_window_scatter(cpu, 4096, 64, 0.05) > 64  # ring wraps
    assert cs.check_window_scatter(cpu, 4096, 64, 0.002) < 64
    assert cs.check_per_update(cpu, 64, 64, 32) > 0


def test_per_sampler_phase(cpu):
    stats = cs.check_per_sampler(cpu, 64, 32, 64, batches=50)
    assert stats["env"][1] == 63 and stats["slot"][1] == 31


def test_flight_phase(cpu):
    assert cs.flight_divergence(cpu, jax.devices("cpu")[1], num_envs=4, frames=10) == 0.0


def test_main_path_phase(capsys):
    cfg = dataclasses.replace(
        lunar_jointed_scaled(16), steps_per_superstep=8, batch_size=16,
        training_start=16, hidden=(32, 32), buffer_capacity=16 * 32,
        lander_vel_iters=10, lander_pos_iters=4)
    out = cs.run_main_path(cfg, 2, "cpu", "tiny", evaluate=True, checkpoint=True)
    assert out["updates"] > 0 and out["env_steps_per_s"] > 0
    log = capsys.readouterr().out
    assert "round trip bitwise ok" in log and "memory_analysis" in log
    assert cs.cartpole_headline().num_envs == 131072


def test_data_parallel_phase():
    cfg = dataclasses.replace(
        multihost_ddqn(), num_envs=32, steps_per_superstep=8, batch_size=32,
        training_start=64, hidden=(32, 32), buffer_capacity=32 * 32)
    out = cs.phase_data_parallel(jax.devices("cpu")[:4], cfg, "cpu", supersteps=2)
    assert out["grad_err"] <= 1e-5


@pytest.mark.parametrize("preset", [True, False])
def test_compile_cache_placement(tmp_path, preset):
    """$JAX_COMPILATION_CACHE_DIR, when set, is where the cache lands;
    unset, it is the checkout's fixed .jax_cache."""
    target = str(tmp_path / "cache")
    extra = {"JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
             "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "0"}
    if preset:
        extra["JAX_COMPILATION_CACHE_DIR"] = target
    out = _run("""
        import jax, jax.numpy as jnp
        from deep_q_learning_tpu.utils.compile_cache import enable_compile_cache
        d = enable_compile_cache()
        jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
        print(d, jax.config.jax_compilation_cache_dir)
    """, extra)
    assert out.returncode == 0, out.stderr
    used, configured = out.stdout.split()
    want = target if preset else os.path.join(_REPO, ".jax_cache")
    assert used == configured == want
    if preset:
        assert os.listdir(target)  # the compiled executable landed there


def test_runs_without_flax_or_orbax(tmp_path):
    """One superstep and a checkpoint round trip with flax and orbax made
    unimportable: neither is a dependency of the training path."""
    out = _run(f"""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("flax", "orbax"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import jax, numpy as np
        from deep_q_learning_tpu.config import DQNConfig
        from deep_q_learning_tpu.train import Trainer
        cfg = DQNConfig(env_id="CartPole-v1", num_envs=8, steps_per_superstep=8,
                        batch_size=16, training_start=16, buffer_capacity=256,
                        hidden=(16,), train_every=1, eps_schedule="linear_step",
                        return_window=8, replay="prioritized", n_step=2)
        tr = Trainer(cfg, workdir={str(tmp_path)!r}).init()
        tr.train(max_env_steps=64, log_every=1, verbose=False)
        before = jax.device_get(tr.runner)
        tr.save(step=64)
        tr.restore(step=64)
        after = jax.device_get(tr.runner)
        assert all(np.array_equal(a, b) for a, b in
                   zip(jax.tree.leaves(before), jax.tree.leaves(after)))
        assert not any(m.split(".")[0] in ("flax", "orbax") for m in sys.modules)
        print("OK")
    """)
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stderr[-3000:]


def test_references_on_gpu(gpu):
    """The reference phase at full width, on the card."""
    cs.phase_references(gpu, jax.devices("cpu")[0])
