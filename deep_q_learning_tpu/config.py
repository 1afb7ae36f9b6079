"""Typed configuration for the framework.

The reference has no config system — hyperparameters live as uppercase
constants in each entry script's ``__main__``
(``/root/reference/Test/lunar_lander.py:23-37``) and as the 20-argument
``Agent`` constructor (``q_agent.py:61-86``).  Here a single frozen dataclass
is the schema; presets below mirror the five benchmark configs in
``BASELINE.json``.

The config is hashable/static, so jitted builders can close over it; every
field that reaches a jaxpr is baked in at trace time (static shapes, static
cadences — XLA-friendly control flow via ``lax.cond`` on step counters).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    # --- environment / orchestration -------------------------------------
    env_id: str = "CartPole-v1"  # "CartPole-v1" | "LunarLander-v2"
    num_envs: int = 4096  # lockstep env instances (the data-parallel axis)
    steps_per_superstep: int = 64  # vector env steps fused into one jit call
    time_fraction_obs: bool = False  # append t/max_steps (ref env.py:19-21)
    max_steps_in_episode: Optional[int] = None  # None -> env default

    # --- algorithm --------------------------------------------------------
    double: bool = True  # double Q-learning (ref q_learning_functions.py:55-58)
    dueling: bool = True  # dueling head (ref dddqn.py:29-31)
    gamma: float = 0.99
    n_step: int = 1  # n-step returns assembled at sample time (replay/nstep.py)
    batch_size: int = 64
    loss: str = "huber"  # "huber" | "mse"
    huber_delta: float = 1.0

    # Deliberate ref-compat quirk switches (SURVEY.md §3.2): default FIXED.
    ref_terminal_quirk: bool = False  # terminal target = q[a]+r instead of r
    truncation_bootstrap: bool = True  # bootstrap through time-limit cuts

    # --- optimizer --------------------------------------------------------
    optimizer: str = "adamw"  # ref Test/lunar_lander.py uses adamw lr 2e-4
    learning_rate: float = 2e-4
    max_grad_norm: Optional[float] = None

    # --- replay -----------------------------------------------------------
    replay: str = "uniform"  # "uniform" | "prioritized"
    buffer_capacity: int = 100_000  # TOTAL transitions across all envs
    training_start: int = 250  # min stored transitions before updates
    per_alpha: float = 0.6
    per_beta: float = 0.4
    per_eps: float = 1e-6
    # decay on the insertion-priority high-water mark per update step; 1.0 =
    # the classic monotone max (sum-tree PER — the default, matching the
    # solve-validated lunar_per recipe and the reference-parity posture),
    # <1.0 lets one outlier |td| stop dominating insertion priorities after
    # the buffer has recycled (VERDICT r2 weak #5 — at 1024 envs a 1M buffer
    # recycles in ~1s, so a monotone max pins EVERY future insert to the
    # all-time outlier).  High-env-count presets opt into 0.999
    # (lunar_per_scaled); see ADVICE r3.
    per_max_decay: float = 1.0

    # --- exploration ------------------------------------------------------
    eps_schedule: str = "exp_episode"  # "exp_episode" (ref) | "linear_step"
    eps_start: float = 1.0
    eps_min: float = 0.15
    eps_decay: float = 0.99  # per-episode multiplicative factor (ref)
    eps_decay_steps: int = 100_000  # env-steps horizon for "linear_step"

    # --- cadences (in vector env steps unless noted) ----------------------
    train_every: int = 4  # ref train_frequency (q_agent.py:186)
    updates_per_step: int = 1
    target_sync_mode: str = "steps"  # "steps" | "episodes" (ref: episodes)
    target_sync_every: int = 500  # used in "steps" mode
    target_replace_episodes: int = 20  # ref replace_frequency (q_agent.py:192)
    target_tau: Optional[float] = None  # if set: Polyak soft update every
    # update step (target <- tau*online + (1-tau)*target) instead of hard sync

    # --- network ----------------------------------------------------------
    hidden: Tuple[int, ...] = (256, 256)
    compute_dtype: str = "float32"  # "float32" | "bfloat16"

    # --- lander physics engine (ignored by other envs) --------------------
    # "jointed": the Box2D-exact 3-body assembly (hull + motorized leg
    # joints, envs/lander_solver.py) — touchdown outcomes emerge from joint
    # loading; the fidelity default.  "rigid": round-2's single rigid body
    # with the calibrated J_CRASH threshold — cheaper per frame; kept for
    # throughput-calibrated presets whose training recipes were tuned on it.
    lander_engine: str = "jointed"
    lander_vel_iters: int = 180  # gym's world.Step(.., 6*30, 2*30)
    lander_pos_iters: int = 60
    # Solver-convergence early exit (envs/lander_solver.py): 0.0 (the
    # Box2D-exact fixed-count loop) everywhere, including all presets.  On
    # real training batches the per-iteration accumulator delta does NOT
    # decay in flight — the joint motor converges at <~0.1%/iteration (b2's
    # motorMass underestimates the ~33x effective leg inertia about the
    # anchor), so ~25% of lanes never drop below even 1e-4 and the vmapped
    # while_loop exits on the slowest lane.  The tol path stays available +
    # unit-tested for single-env / research use, where per-lane exit pays.
    lander_vel_tol: float = 0.0

    def env_param_overrides(self) -> dict:
        """Param overrides for make_env (unknown fields are ignored there)."""
        return {
            "jointed": self.lander_engine == "jointed",
            "vel_iters": self.lander_vel_iters,
            "pos_iters": self.lander_pos_iters,
            "vel_tol": self.lander_vel_tol,
        }

    # --- termination / metrics -------------------------------------------
    return_window: int = 50  # ref 50-episode average (q_agent.py:123-126)
    solve_threshold: Optional[float] = None  # ref reward_to_reach 230.0

    # --- misc -------------------------------------------------------------
    seed: int = 0

    @property
    def capacity_per_env(self) -> int:
        return max(1, self.buffer_capacity // self.num_envs)


# ---------------------------------------------------------------------------
# Presets: the five benchmark configs from BASELINE.json.
# ---------------------------------------------------------------------------

def lunar_ref_parity() -> DQNConfig:
    """Config 1: LunarLander double DQN, reference hyperparams, single env
    (ref ``Test/lunar_lander.py:23-37``)."""
    return DQNConfig(
        env_id="LunarLander-v2",
        num_envs=1,
        steps_per_superstep=256,
        time_fraction_obs=True,
        max_steps_in_episode=1500,
        double=True,
        dueling=True,
        gamma=0.99,
        batch_size=64,
        optimizer="adamw",
        learning_rate=2e-4,
        buffer_capacity=100_000,
        training_start=250,
        eps_schedule="exp_episode",
        eps_start=1.0,
        eps_min=0.15,
        eps_decay=0.99,
        train_every=4,
        target_sync_mode="episodes",
        target_replace_episodes=20,
        hidden=(32, 64),
        return_window=50,
        solve_threshold=230.0,
    )


def cartpole_vector() -> DQNConfig:
    """Config 2: CartPole vanilla DQN, 4096 parallel pure-JAX envs."""
    return DQNConfig(
        env_id="CartPole-v1",
        num_envs=4096,
        steps_per_superstep=64,
        double=False,
        dueling=False,
        gamma=0.99,
        batch_size=512,
        learning_rate=1e-3,
        buffer_capacity=1 << 20,
        training_start=10_000,
        eps_schedule="linear_step",
        eps_start=1.0,
        eps_min=0.05,
        eps_decay_steps=250_000,
        train_every=1,
        target_sync_mode="steps",
        target_sync_every=250,
        hidden=(256, 256),
        return_window=512,
        solve_threshold=475.0,
    )


def lunar_dddqn_vector() -> DQNConfig:
    """Config 3: LunarLander dueling double DQN, on-device uniform replay,
    jit-fused step+update.

    Training result from the previous chip, to re-check on the GPU: n-step-3
    + adam + Polyak τ=0.005 trained stably to ~160 window / ~172 greedy eval
    at 100M env steps (1-step variants with periodic hard sync peaked near 0
    and then diverged)."""
    return DQNConfig(
        env_id="LunarLander-v2",
        num_envs=128,
        steps_per_superstep=128,
        time_fraction_obs=True,
        max_steps_in_episode=1000,
        double=True,
        dueling=True,
        gamma=0.99,
        n_step=3,
        batch_size=256,
        optimizer="adam",
        learning_rate=3e-4,
        max_grad_norm=10.0,
        buffer_capacity=1 << 19,
        training_start=20_000,
        eps_schedule="linear_step",
        eps_start=1.0,
        eps_min=0.02,
        eps_decay_steps=300_000,
        train_every=1,
        target_tau=0.005,
        hidden=(256, 256),
        return_window=256,
        # round-2-calibrated fast engine; training recipe (Polyak/n-step/lr)
        # was tuned on it.  The jointed engine is the fidelity default
        # elsewhere (lunar_ref_parity) — see DQNConfig.lander_engine.
        lander_engine="rigid",
        solve_threshold=200.0,
    )


def lunar_per() -> DQNConfig:
    """Config 4: LunarLander DDQN + prioritized replay (device two-level
    proportional sampler).  The SOLVING config: on the previous chip it
    reached window 202 / greedy eval 204 at 29.5M env steps (an earlier-chip
    training result, to re-check on the GPU)."""
    return dataclasses.replace(
        lunar_dddqn_vector(),
        replay="prioritized",
        per_alpha=0.6,
        per_beta=0.4,
        eps_min=0.01,
    )


def lunar_per_scaled(num_envs: int = 1024) -> DQNConfig:
    """``lunar_per`` scaled to a large env count with the sample-per-
    transition ratio held constant: batch grows with the env count and the
    update cadence stretches so each generated transition is still sampled
    ~0.25x per frame window (the 128-env solving preset samples 2x).  Large
    batches amortize the learner's fixed per-launch costs (bench.py uses
    this config for the 1024-env lander line).

    The stretched cadence needs compensation to keep SOLVING: Polyak tau
    scales with train_every (same tracking speed per wall-clock update
    stream) and the exploration horizon scales with the env count (same
    per-env experience).  On the previous chip, uncompensated
    batch-1024-every-4 peaked at window 45; compensated it solved at 42M
    steps with greedy eval 203 (earlier-chip training results, to re-check
    on the GPU)."""
    scale = max(1, num_envs // 128)
    train_every = 4 if num_envs >= 512 else 1
    return dataclasses.replace(
        lunar_per(),
        num_envs=num_envs,
        batch_size=max(256, num_envs),
        train_every=train_every,
        target_tau=0.005 * train_every,
        eps_decay_steps=min(2_000_000, 300_000 * scale),
        buffer_capacity=max(1 << 19, num_envs * 64),
        # buffer recycles in seconds at this env count: decay the insertion-
        # priority high-water mark so one outlier |td| can't pin every insert
        per_max_decay=0.999,
    )


def lunar_jointed_scaled(num_envs: int = 1024) -> DQNConfig:
    """The FIDELITY engine at bench scale: ``lunar_per_scaled`` hyperparams
    on the Box2D-exact jointed 3-body assembly (``envs/lander_solver.py``).

    Solver iterations run at (120, 40) — frame-exact against gym's
    (180, 60) on the touchdown-settle harness (tests/test_lander_solver.py:
    the measured fidelity boundary is ~60 velocity iterations, below which
    the leg joints give way under landing load), at ~1.5x the per-frame
    solver cost of the gym counts."""
    return dataclasses.replace(
        lunar_per_scaled(num_envs),
        lander_engine="jointed",
        lander_vel_iters=120,
        lander_pos_iters=40,
    )


def lunar_jointed_per() -> DQNConfig:
    """Solving preset ON the fidelity engine (VERDICT r3 item 6): the
    ``lunar_per`` recipe with the jointed 3-body physics.

    Solve-validated 3/3 seeds on the previous chip: windows
    213.5/201.0/201.4 at 2.9-3.6M env steps, true greedy evals
    230.5/213.5/201.2 (earlier-chip training results, to re-check on the
    GPU); a CPU-backend 3/3 run measured the same band, windows 204-234 at
    2.9-4.1M (artifacts/lunar_jointed_solve_cpu*.json).  The faithful joint
    dynamics solve ~7x faster in env steps than the same recipe on the
    rigid engine (29.5M): leg-joint compliance smooths the touchdown
    reward landscape."""
    return dataclasses.replace(
        lunar_per(),
        lander_engine="jointed",
        lander_vel_iters=120,
        lander_pos_iters=40,
    )


def acrobot_vector() -> DQNConfig:
    """Generality preset (VERDICT r4 missing #4): the task-agnostic L2 on a
    third env family.  Acrobot-v1 (gym-cross-validated to ~6.5e-5 —
    ``envs/gym_compat.py::compare_classic``), the ``lunar_dddqn_vector``
    recipe with a shorter exploration horizon; solved (window >= -100)
    well inside 5M env steps on the previous chip (to re-check on the
    GPU)."""
    return dataclasses.replace(
        lunar_dddqn_vector(),
        env_id="Acrobot-v1",
        time_fraction_obs=False,
        max_steps_in_episode=500,
        eps_decay_steps=150_000,
        eps_min=0.05,
        lander_engine="rigid",  # ignored by Acrobot; keeps cfg minimal
        solve_threshold=-100.0,
    )


def mountain_car_vector() -> DQNConfig:
    """MountainCar-v0 (VERDICT r4 missing #4).  The hard-exploration
    classic: reward is -1/step until the goal, so an eps-greedy DQN only
    learns after a lucky rollout reaches the flag.  n-step-5 returns give
    the vectorized sweep enough random goal-hits to bootstrap from; on the
    previous chip it solved at 4.26M env steps (window -107.1, bar -110;
    greedy eval -102.9; an earlier-chip training result, to re-check on the
    GPU).
    An eps floor of 0.1 learns the same greedy policy (eval -99.7) but the
    exploration noise keeps the training window ~16 points below it —
    anneal to 0.02 to let the window express the policy."""
    return dataclasses.replace(
        lunar_dddqn_vector(),
        env_id="MountainCar-v0",
        time_fraction_obs=False,
        max_steps_in_episode=200,
        n_step=5,
        eps_schedule="linear_step",
        eps_decay_steps=600_000,
        eps_min=0.02,
        training_start=50_000,
        lander_engine="rigid",
        solve_threshold=-110.0,
    )


def multihost_ddqn() -> DQNConfig:
    """Config 5: multi-host DDQN — envs sharded over the mesh, replicated
    learner with gradient all-reduce.  Same algorithm config as
    config 3; the sharding comes from ``parallel.make_distributed_superstep``."""
    return dataclasses.replace(lunar_dddqn_vector(), num_envs=8192)


# Fields that change compiled array shapes or program structure: a checkpoint
# written under one value cannot restore into a trainer built with another
# (the failure would otherwise surface as a bare tree/leaf mismatch at
# restore — see Trainer.restore's cross-check).
SHAPE_AFFECTING_FIELDS = (
    "env_id",
    "num_envs",
    "steps_per_superstep",
    "time_fraction_obs",
    "max_steps_in_episode",
    "double",
    "dueling",
    "n_step",
    "batch_size",
    "loss",
    "optimizer",
    "replay",
    "buffer_capacity",
    "eps_schedule",
    "target_sync_mode",
    "hidden",
    "compute_dtype",
    "return_window",
    # lander engine selection changes the traced program AND the env-state
    # pytree structure (jointed adds leg bodies + solver accumulators)
    "lander_engine",
    "lander_vel_iters",
    "lander_pos_iters",
    "lander_vel_tol",
)


def config_to_dict(cfg: DQNConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["hidden"] = list(d["hidden"])
    return d


def config_shape_mismatches(saved: dict, cfg: DQNConfig) -> dict:
    """Shape-affecting fields that differ between a saved config dict and
    ``cfg`` (plus Polyak/clip path presence, which is compiled in/out)."""
    cur = config_to_dict(cfg)
    bad = {}
    for f in SHAPE_AFFECTING_FIELDS:
        if f in saved and saved[f] != cur[f]:
            bad[f] = (saved[f], cur[f])
    for f in ("target_tau", "max_grad_norm"):
        if f in saved and (saved[f] is None) != (cur[f] is None):
            bad[f] = (saved[f], cur[f])
    return bad


PRESETS = {
    "lunar_ref_parity": lunar_ref_parity,
    "cartpole_vector": cartpole_vector,
    "lunar_dddqn_vector": lunar_dddqn_vector,
    "lunar_per": lunar_per,
    "lunar_per_scaled": lunar_per_scaled,
    "lunar_jointed_scaled": lunar_jointed_scaled,
    "lunar_jointed_per": lunar_jointed_per,
    "acrobot_vector": acrobot_vector,
    "mountain_car_vector": mountain_car_vector,
    "multihost_ddqn": multihost_ddqn,
}
