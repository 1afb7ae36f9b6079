"""CLI (`python -m deep_q_learning_tpu`) — config overrides and end-to-end
train/eval on tiny shapes (CPU backend via conftest)."""

import json

import pytest

from deep_q_learning_tpu.__main__ import build_config, main


def test_build_config_overrides():
    cfg = build_config(
        "cartpole_vector",
        [
            "num_envs=8",
            "hidden=16,16",
            "target_tau=0.01",
            "max_grad_norm=none",
            "double=true",
            "solve_threshold=123.5",
        ],
    )
    assert cfg.num_envs == 8
    assert cfg.hidden == (16, 16)
    assert cfg.target_tau == pytest.approx(0.01)
    assert cfg.max_grad_norm is None
    assert cfg.double is True
    assert cfg.solve_threshold == pytest.approx(123.5)


def test_build_config_rejects_unknown_field():
    with pytest.raises(SystemExit):
        build_config("cartpole_vector", ["nonsense=1"])


def test_presets_listing(capsys):
    assert main(["presets", "--fields"]) == 0
    out = capsys.readouterr().out
    assert "lunar_per" in out
    assert "num_envs" in out


TINY = [
    "--set", "num_envs=8",
    "--set", "steps_per_superstep=8",
    "--set", "hidden=16,16",
    "--set", "batch_size=16",
    "--set", "buffer_capacity=512",
    "--set", "training_start=32",
    "--set", "return_window=8",
]


def test_cli_train_eval_roundtrip(tmp_path, capsys):
    workdir = str(tmp_path / "run")
    rc = main(
        ["train", "--preset", "cartpole_vector", *TINY,
         "--max-env-steps", "512", "--log-every", "2",
         "--checkpoint-every", "2", "--workdir", workdir, "--quiet",
         "--history-out", str(tmp_path / "hist.jsonl")]
    )
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["env_steps"] >= 512
    hist = [json.loads(l) for l in open(tmp_path / "hist.jsonl")]
    assert hist and "window_mean" in hist[0]

    rc = main(
        ["eval", "--preset", "cartpole_vector", *TINY, "--workdir", workdir,
         "--rollout-dir", str(tmp_path / "rollouts"), "--rollouts", "2"]
    )
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    report = json.loads(out[0])
    assert report["episodes"] >= 8
    assert report["length_mean"] > 0
    assert (tmp_path / "rollouts" / "rollout_1.npz").exists()

    # resume: restore the latest checkpoint and keep training
    rc = main(
        ["train", "--preset", "cartpole_vector", *TINY, "--resume",
         "--max-env-steps", "1024", "--log-every", "2",
         "--workdir", workdir, "--quiet"]
    )
    assert rc == 0
    resumed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert resumed["env_steps"] >= 1024


def test_cli_train_distributed(capsys):
    rc = main(
        ["train", "--preset", "multihost_ddqn", *TINY,
         "--set", "training_start=8", "--set", "batch_size=8",
         "--max-env-steps", "128", "--log-every", "1",
         "--distributed", "--quiet"]
    )
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["env_steps"] >= 128
