"""Smoke run of the device-resident DQN trainer on one NVIDIA GPU.

    python chip_smoke.py             # one card: phases 1-3 below
    python chip_smoke.py --cards 4   # four cards: the data-parallel phase only

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``), JAX's device
   kind and the compile-cache directory.
2. references: the TD target + huber loss and its gradient, the Q-network
   forward, the exact one-hot writes (return window, PER priorities), the
   PER sampler and the jointed lander's flight, each against a plain
   reference (float64 numpy, or the same program on the CPU device).
3. main path: ``Trainer(lunar_jointed_scaled(1024))`` trains, evaluates and
   round-trips a checkpoint; then cartpole at 131072 envs trains.  Each
   prints env-steps/s, compile seconds and the step's memory analysis.

The program has no hand-written kernel: every phase runs what XLA compiles
for the card.

The last line is one JSON object naming the device.  The script insists on
a GPU: on any other backend it exits non-zero before printing it.  The phase
functions take sizes and devices as arguments, so CPU tests call them at
tiny sizes.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import shutil
import sys
import tempfile
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseError(AssertionError):
    """A phase's result is outside its tolerance."""


def check(ok, msg: str) -> None:
    if not ok:
        raise PhaseError(msg)


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref| (normwise; safe where ref crosses 0)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def bitwise_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def tf32_inexact_share(x) -> float:
    """Share of float32 values that TF32 (10 mantissa bits) cannot hold."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return float(np.mean((bits & 0x1FFF) != 0))


# ---------------------------------------------------------------------------
# phase 2: references
# ---------------------------------------------------------------------------

def td_loss_reference(q_s, q_no, q_nt, action, reward, bootstrap, weights,
                      double: bool, delta: float = 1.0):
    """float64 numpy ``(loss, td, dL/dQ(s))``."""
    q_s, q_no, q_nt, reward, bootstrap, weights = (
        np.asarray(x, np.float64)
        for x in (q_s, q_no, q_nt, reward, bootstrap, weights))
    rows = np.arange(q_s.shape[0])
    boot = q_nt[rows, np.argmax(q_no, axis=1)] if double else q_nt.max(axis=1)
    td = reward + bootstrap * boot - q_s[rows, action]
    mag = np.abs(td)
    quad = np.minimum(mag, delta)
    loss = np.mean(weights * (0.5 * quad**2 + delta * (mag - quad)))
    dq = np.zeros_like(q_s)
    dq[rows, action] = -weights * np.clip(td, -delta, delta) / q_s.shape[0]
    return loss, td, dq


def td_inputs(b: int, a: int, seed: int = 0):
    """Q-values and batch columns with full float32 mantissas."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    return (
        f32(rng.normal(size=(b, a))),  # Q(s)
        f32(rng.normal(size=(b, a))),  # Q_online(s')
        f32(rng.normal(size=(b, a))),  # Q_target(s')
        rng.integers(0, a, size=b).astype(np.int32),
        f32(rng.normal(size=b) * 2.0),
        f32(0.97 * (rng.random(b) > 0.2)),
        f32(rng.random(b) + 0.05),
    )


def q_value_loss(double: bool):
    """The repo's loss with the Q-values as the network input.

    The "network" selects one half of a ``(B, 2A)`` observation: online
    params ``[1, 0]`` read the first half, target params ``[0, 1]`` the
    second.  ``x·1 + y·0`` is exact, so the loss sees the given Q-values."""
    from deep_q_learning_tpu.algos.losses import build_loss_fn

    def apply_fn(p, x):
        a = x.shape[1] // 2
        return p[0] * x[:, :a] + p[1] * x[:, a:]

    return build_loss_fn(apply_fn, double=double, loss="huber")


def td_loss_on_device(device, loss_fn, q_s, q_no, q_nt, action, reward,
                      bootstrap, weights):
    """``(loss, td, dL/dQ(s))`` of ``loss_fn`` run on ``device``."""
    import jax
    import jax.numpy as jnp

    from deep_q_learning_tpu.replay.nstep import LearnBatch

    def run(q_s, q_no, q_nt, action, reward, bootstrap, weights):
        online = jnp.array([1.0, 0.0], jnp.float32)
        target = jnp.array([0.0, 1.0], jnp.float32)
        next_obs = jnp.concatenate([q_no, q_nt], axis=1)

        def f(q):
            obs = jnp.concatenate([q, jnp.zeros_like(q)], axis=1)
            batch = LearnBatch(obs=obs, action=action, reward=reward,
                               next_obs=next_obs, bootstrap=bootstrap)
            return loss_fn(online, target, batch, weights)

        (loss, td), dq = jax.value_and_grad(f, has_aux=True)(q_s)
        return loss, td, dq

    args = [jax.device_put(x, device)
            for x in (q_s, q_no, q_nt, action, reward, bootstrap, weights)]
    return [np.asarray(x) for x in jax.jit(run)(*args)]


def check_td_loss(device, b: int, a: int, double: bool) -> float:
    """Plain TD target + huber loss and its gradient against float64.
    rtol 1e-5, atol 1e-6: no matmul, only the batch sum's order differs."""
    inputs = td_inputs(b, a)
    got = td_loss_on_device(device, q_value_loss(double), *inputs)
    ref = td_loss_reference(*inputs, double=double)
    worst = 0.0
    for name, g, r in zip(("loss", "td", "dQ"), got, ref):
        err = float(np.max(np.abs(np.asarray(g, np.float64) - r)))
        worst = max(worst, err)
        check(np.allclose(g, r, rtol=1e-5, atol=1e-6),
              f"TD {name} B={b} A={a} double={double}: max abs err {err:.3g}")
    return worst


def qnet_forward_errors(device, batch: int = 1024, obs_dim: int = 9,
                        hidden=(256, 256), num_actions: int = 4):
    """Dueling Q-network forward on ``device`` at HIGHEST and at default
    matmul precision, each against float64: ``(err_highest, err_default)``
    as max error over max |Q|."""
    import jax

    from deep_q_learning_tpu.models import QNetwork

    net = QNetwork(num_actions=num_actions, hidden=tuple(hidden), dueling=True)
    params = net.init(jax.random.PRNGKey(0), np.zeros((1, obs_dim), np.float32))
    x = np.random.default_rng(1).normal(size=(batch, obs_dim)).astype(np.float32)

    p64 = jax.tree.map(lambda v: np.asarray(v, np.float64), params)["params"]
    h = x.astype(np.float64)
    for i in range(len(hidden)):
        h = np.maximum(h @ p64[f"trunk_{i}"]["kernel"] + p64[f"trunk_{i}"]["bias"], 0)
    val = h @ p64["value"]["kernel"] + p64["value"]["bias"]
    adv = h @ p64["advantage"]["kernel"] + p64["advantage"]["bias"]
    ref = val + adv - adv.mean(axis=1, keepdims=True)

    dev_params = jax.device_put(params, device)
    dev_x = jax.device_put(x, device)
    with jax.default_matmul_precision("highest"):
        hi = np.asarray(jax.jit(net.apply)(dev_params, dev_x))
    lo = np.asarray(jax.jit(net.apply)(dev_params, dev_x))
    return rel_err(hi, ref), rel_err(lo, ref), np.allclose(lo, ref, rtol=2e-2, atol=2e-2)


def check_window_scatter(device, n: int, w: int, p_done: float, seed: int = 0) -> int:
    """``_scatter_completed_returns`` bitwise against in-order writes."""
    import jax

    from deep_q_learning_tpu.algos.superstep import _scatter_completed_returns

    rng = np.random.default_rng(seed)
    window = (rng.normal(size=w) * 100).astype(np.float32)
    returns = (rng.normal(size=n) * 100).astype(np.float32)
    done = rng.random(n) < p_done
    cursor, filled = int(rng.integers(0, w)), int(rng.integers(0, w))
    check(tf32_inexact_share(returns) > 0.9, "window inputs are TF32-exact")

    put = lambda x: jax.device_put(x, device)
    got = jax.jit(_scatter_completed_returns)(
        put(window), put(np.int32(cursor)), put(np.int32(filled)),
        put(done), put(returns))
    got = [np.asarray(x) for x in got]

    ref = window.copy()
    vals = returns[done]
    for i, v in enumerate(vals):  # the plain semantics: in-order writes
        ref[(cursor + i) % w] = v
    check(bitwise_equal(got[0], ref), f"window N={n} W={w}: not bitwise equal")
    check(int(got[1]) == (cursor + len(vals)) % w, "window cursor")
    check(int(got[2]) == min(filled + len(vals), w), "window filled")
    return len(vals)


def check_per_update(device, b: int, n: int, c: int, seed: int = 0) -> int:
    """PER one-hot priority update bitwise against ``.at[].set/.at[].max``,
    with duplicate (env, slot) pairs, groups of two and three."""
    import jax
    import jax.numpy as jnp

    from deep_q_learning_tpu.envs.base import Transition
    from deep_q_learning_tpu.replay.prioritized import PrioritizedReplay, SampleInfo

    check(b * (n + c) <= (1 << 22), "shape takes the scatter path, not the one-hot")
    rng = np.random.default_rng(seed)
    replay = PrioritizedReplay(n, c, alpha=0.6, eps=1e-6)
    env_idx = rng.integers(0, n, size=b).astype(np.int32)
    slot_idx = rng.integers(0, c, size=b).astype(np.int32)
    env_idx[1:3], slot_idx[1:3] = env_idx[0], slot_idx[0]  # a group of three
    env_idx[4], slot_idx[4] = env_idx[3], slot_idx[3]  # a pair
    td = (rng.normal(size=b) * 3).astype(np.float32)
    prio = rng.random((n, c)).astype(np.float32)
    check(tf32_inexact_share(np.abs(td)) > 0.9, "PER inputs are TF32-exact")

    def run(prio, env_idx, slot_idx, td):
        example = Transition(
            obs=jnp.zeros((n, 1)), action=jnp.zeros((n,), jnp.int32),
            reward=jnp.zeros((n,)), next_obs=jnp.zeros((n, 1)),
            terminated=jnp.zeros((n,), bool), truncated=jnp.zeros((n,), bool))
        state = replay.init(example).replace(priorities=prio)
        new = replay.update_priorities(state, SampleInfo(env_idx, slot_idx), td)
        new_p = (jnp.abs(td) + replay.eps) ** replay.alpha
        ref = prio.at[env_idx, slot_idx].set(0.0).at[env_idx, slot_idx].max(new_p)
        return new.priorities, ref, new_p

    put = lambda x: jax.device_put(x, device)
    got, ref, new_p = (np.asarray(x) for x in jax.jit(run)(
        put(prio), put(env_idx), put(slot_idx), put(td)))
    check(tf32_inexact_share(new_p) > 0.9, "PER priorities are TF32-exact")
    check(bitwise_equal(got, ref),
          f"PER update B={b} N={n} C={c}: {int(np.sum(got != ref))} entries differ")
    return int(np.sum(got != prio))


def check_per_sampler(device, n: int, c: int, b: int, batches: int, seed: int = 0):
    """Sampler frequencies against exact probabilities (chi-square over the
    env and slot marginals), and ``p_sel == p[e, s] / total`` exactly."""
    import jax
    import jax.numpy as jnp

    from deep_q_learning_tpu.envs.base import Transition
    from deep_q_learning_tpu.replay.prioritized import PrioritizedReplay

    rng = np.random.default_rng(seed)
    prio = np.exp(rng.normal(size=(n, c))).astype(np.float32)
    replay = PrioritizedReplay(n, c, alpha=1.0, n_step=1)

    def draw(prio, keys):
        example = Transition(
            obs=jnp.zeros((n, 1)), action=jnp.zeros((n,), jnp.int32),
            reward=jnp.zeros((n,)), next_obs=jnp.zeros((n, 1)),
            terminated=jnp.zeros((n,), bool), truncated=jnp.zeros((n,), bool))
        state = replay.init(example).replace(
            priorities=prio, total_adds=jnp.int32(c))  # full ring
        return jax.vmap(lambda k: replay.sample_indices(state, k, b))(keys)

    keys = jax.random.split(jax.random.PRNGKey(seed), batches)
    env_idx, slot_idx, p_sel, total = (np.asarray(x) for x in jax.jit(draw)(
        jax.device_put(prio, device), jax.device_put(keys, device)))

    # p_sel must be exactly the drawn entry over the total, as the device
    # divides (XLA:GPU's float32 division may differ from IEEE by an ulp)
    divide = jax.jit(lambda p, e, s, t: p[e, s] / t[:, None])
    want = np.asarray(divide(*(jax.device_put(x, device)
                               for x in (prio, env_idx, slot_idx, total))))
    check(bitwise_equal(p_sel, want), "PER p_sel != priorities[e, s] / total")
    ieee = prio[env_idx, slot_idx] / total[:, None]
    ulps = int(np.max(np.abs(p_sel.view(np.int32) - ieee.view(np.int32))))
    p64 = prio.astype(np.float64)
    check(abs(float(total[0]) / p64.sum() - 1) < 1e-5, "PER total")
    stats = {}
    for name, idx, probs in (("env", env_idx, p64.sum(1) / p64.sum()),
                             ("slot", slot_idx, p64.sum(0) / p64.sum())):
        draws = idx.size
        counts = np.bincount(idx.ravel(), minlength=probs.size)
        expected = probs * draws
        chi2 = float(np.sum((counts - expected) ** 2 / expected))
        dof = probs.size - 1
        bound = dof + 6.0 * np.sqrt(2.0 * dof)  # ~6 sigma of chi2(dof)
        check(chi2 < bound, f"PER {name} chi2 {chi2:.1f} >= {bound:.1f}")
        stats[name] = (chi2, dof)
    stats["ulps_vs_ieee_division"] = ulps
    return stats


def flight_divergence(dev_a, dev_b, num_envs: int = 64, frames: int = 50,
                      seed: int = 0) -> float:
    """Jointed lander under fixed actions on two devices: max observation
    difference over the frames in which no env has landed or crashed on
    either device."""
    import jax
    import jax.numpy as jnp

    from deep_q_learning_tpu.config import lunar_jointed_scaled
    from deep_q_learning_tpu.envs import make_env

    cfg = lunar_jointed_scaled(num_envs)
    env, params = make_env(cfg.env_id, param_overrides=cfg.env_param_overrides())
    actions = (np.arange(num_envs)[None, :] + np.arange(frames)[:, None] // 5) % 4

    def fly(key, actions):
        k_reset, k_step = jax.random.split(key)
        obs, state = jax.vmap(env.reset, in_axes=(0, None))(
            jax.random.split(k_reset, num_envs), params)

        def frame(carry, xs):
            state, alive = carry
            t, act = xs
            keys = jax.random.split(jax.random.fold_in(k_step, t), num_envs)
            obs, state, _, term, trunc = jax.vmap(
                env.step, in_axes=(0, 0, 0, None))(keys, state, act, params)
            alive = alive & ~term & ~trunc
            return (state, alive), (obs, alive)

        _, (traj, alive) = jax.lax.scan(
            frame, (state, jnp.ones(num_envs, bool)),
            (jnp.arange(frames), actions.astype(jnp.int32)))
        return traj, alive

    out = []
    for dev in (dev_a, dev_b):
        key = jax.device_put(jax.random.PRNGKey(seed), dev)
        traj, alive = jax.jit(fly)(key, jax.device_put(actions, dev))
        out.append((np.asarray(traj), np.asarray(alive)))
    (ta, la), (tb, lb) = out
    both = la & lb
    check(both.mean() > 0.5, f"flight: only {both.mean():.2f} of env-frames in flight")
    return float(np.max(np.abs(ta - tb)[both]))


def phase_references(gpu, cpu) -> None:
    log("phase 2: references")
    for b, a in ((1024, 4), (512, 2)):
        for double in (True, False):
            err = check_td_loss(gpu, b, a, double)
            log(f"  td+huber+grad B={b} A={a} double={double}: max abs err {err:.3g} "
                "(rtol 1e-5, atol 1e-6) ok")
    hi, lo, lo_ok = qnet_forward_errors(gpu)
    log(f"  qnet (256,256) dueling, 9 inputs, B=1024: err highest {hi:.3g} (<= 1e-5), "
        f"err default {lo:.3g} (rtol/atol 2e-2)")
    check(hi <= 1e-5, f"qnet highest-precision err {hi:.3g} > 1e-5")
    check(lo_ok, f"qnet default-precision err {lo:.3g} beyond rtol/atol 2e-2")
    for p_done in (0.01, 0.0002):
        k = check_window_scatter(gpu, 131072, 512, p_done)
        log(f"  return window N=131072 W=512, {k} completions: bitwise equal ok")
    k = check_per_update(gpu, 1024, 1024, 512)
    log(f"  PER priority update B=1024 N=1024 C=512 ({k} entries written): bitwise equal ok")
    stats = check_per_sampler(gpu, 1024, 512, 1024, batches=200)
    log(f"  PER sampler N=1024 C=512 B=1024 x200: p_sel exact (max "
        f"{stats['ulps_vs_ieee_division']} ulp from IEEE division); " + ", ".join(
            f"{k} chi2 {stats[k][0]:.1f} (dof {stats[k][1]})" for k in ("env", "slot")))
    err = flight_divergence(gpu, cpu)
    log(f"  jointed lander flight, 64 envs x 50 frames, gpu vs cpu: max obs diff "
        f"{err:.3g} (<= 1e-4)")
    check(err <= 1e-4, f"lander flight divergence {err:.3g} > 1e-4")


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def memory_summary(compiled) -> str:
    mem = compiled.memory_analysis()
    if mem is None:
        return "memory_analysis: n/a"
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes")
    return "memory_analysis: " + ", ".join(
        f"{f.replace('_size_in_bytes', '')} {getattr(mem, f, 0) / 2**20:.1f} MiB"
        for f in fields)


def compile_trainer(tr) -> tuple:
    """AOT-compile the trainer's superstep for its runner; returns
    ``(compile_seconds, compiled)`` and installs the executable."""
    t0 = time.perf_counter()
    compiled = tr._superstep.lower(tr.runner).compile()
    tr._superstep = compiled
    return time.perf_counter() - t0, compiled


def timed_train(tr, supersteps: int) -> tuple:
    """One untimed superstep, then ``supersteps`` more; ``(result,
    env_steps_per_s)`` of the latter, timed against the host fetch of the
    last superstep's metrics.  A program's first execution carries one-time
    set-up (autotuning, NCCL communicators on several cards)."""
    per = tr.cfg.steps_per_superstep * tr.cfg.num_envs
    tr.train(max_env_steps=per, log_every=1, verbose=False)
    t0 = time.perf_counter()
    res = tr.train(max_env_steps=(1 + supersteps) * per, log_every=supersteps,
                   verbose=False)
    return res, supersteps * per / (time.perf_counter() - t0)


def run_main_path(cfg, supersteps: int, card: str, label: str,
                  evaluate: bool = False, checkpoint: bool = False) -> dict:
    """Drive ``Trainer`` through init, training, and optionally evaluation and
    a checkpoint round trip; print and return its numbers."""
    import jax

    from deep_q_learning_tpu.train import Trainer

    tr = Trainer(cfg).init()
    params0 = jax.device_get(tr.runner.train.params)
    compile_s, compiled = compile_trainer(tr)
    res, sps = timed_train(tr, supersteps)
    hist = res.history[-1]
    check(np.isfinite(hist["loss"]), f"{label}: loss {hist['loss']}")
    check(float(tr.runner.train.updates) > 0, f"{label}: the learner never ran")
    expected = (1 + supersteps) * cfg.steps_per_superstep * cfg.num_envs
    check(res.env_steps == expected, f"{label}: env steps {res.env_steps} != {expected}")
    moved = any(not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(params0), jax.tree.leaves(jax.device_get(tr.runner.train.params))))
    check(moved, f"{label}: params did not change")
    out = {"env_steps_per_s": sps, "compile_s": compile_s, "loss": hist["loss"],
           "updates": int(tr.runner.train.updates)}
    log(f"  {label}: {sps:,.0f} env-steps/s over {supersteps} supersteps after 1 "
        f"untimed ({res.env_steps} env steps in all, {out['updates']} updates, "
        f"loss {hist['loss']:.4f}); "
        f"compile {compile_s:.1f} s; card {card}")
    log(f"  {label}: {memory_summary(compiled)}")
    if evaluate:
        ev = tr.evaluate(seed=0)
        check(np.all(np.isfinite(ev.returns)), f"{label}: eval returns not finite")
        log(f"  {label}: evaluate() {ev.returns.shape[0]} episodes, "
            f"mean return {float(np.mean(ev.returns)):.1f}")
    if checkpoint:
        workdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            snapshot = jax.device_get(tr.runner)
            tr.workdir = workdir
            tr.save(step=res.env_steps)
            tr.restore(step=res.env_steps)
            same = all(bitwise_equal(a, b) for a, b in zip(
                jax.tree.leaves(snapshot), jax.tree.leaves(jax.device_get(tr.runner))))
            check(same, f"{label}: checkpoint round trip is not bitwise")
            log(f"  {label}: save()/restore() round trip bitwise ok")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    return out


def cartpole_headline(num_envs: int = 131072):
    """The bench's cartpole configuration (``bench.py``)."""
    from deep_q_learning_tpu.config import cartpole_vector

    return dataclasses.replace(
        cartpole_vector(), num_envs=num_envs,
        buffer_capacity=max(1 << 20, num_envs * 64))


def phase_main_path(card: str) -> None:
    from deep_q_learning_tpu.config import lunar_jointed_scaled

    log("phase 3: main path")
    cfg = lunar_jointed_scaled(1024)
    check(cfg.training_start < cfg.steps_per_superstep * cfg.num_envs,
          "the learner would not run in every superstep")
    run_main_path(cfg, 4, card, "lunar_jointed_scaled(1024)",
                  evaluate=True, checkpoint=True)
    run_main_path(cartpole_headline(), 4, card, "cartpole@131072")


# ---------------------------------------------------------------------------
# --cards N: env-sharded data parallelism
# ---------------------------------------------------------------------------

def allreduced_vs_single_grad(mesh, cfg, params, per_shard_batch: int,
                              seed: int = 0) -> float:
    """One gradient all-reduced over ``mesh`` (per-shard batches, pmean) vs
    the single-device gradient over the concatenated batch, at HIGHEST
    precision: max normwise relative error over the leaves."""
    import jax
    from jax.sharding import PartitionSpec as P

    from deep_q_learning_tpu.algos.losses import build_loss_fn
    from deep_q_learning_tpu.envs import make_env
    from deep_q_learning_tpu.models import QNetwork
    from deep_q_learning_tpu.parallel.mesh import ENV_AXIS
    from deep_q_learning_tpu.replay.nstep import LearnBatch

    env, env_params = make_env(cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode)
    (obs_dim,) = env.obs_shape(env_params)
    net = QNetwork(num_actions=env.num_actions, hidden=cfg.hidden, dueling=cfg.dueling)
    loss_fn = build_loss_fn(net.apply, double=cfg.double, loss=cfg.loss)
    shards = mesh.devices.size
    b = per_shard_batch * shards
    rng = np.random.default_rng(seed)
    batch = LearnBatch(
        obs=rng.normal(size=(b, obs_dim)).astype(np.float32),
        action=rng.integers(0, env.num_actions, size=b).astype(np.int32),
        reward=rng.normal(size=b).astype(np.float32),
        next_obs=rng.normal(size=(b, obs_dim)).astype(np.float32),
        bootstrap=(0.99 * (rng.random(b) > 0.1)).astype(np.float32),
    )
    weights = (rng.random(b) + 0.1).astype(np.float32)
    grad = lambda p, bt, w: jax.grad(lambda q: loss_fn(q, q, bt, w)[0])(p)

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh, out_specs=P(), check_vma=False,
                       in_specs=(P(), P(ENV_AXIS), P(ENV_AXIS)))
    def sharded(p, bt, w):
        return jax.lax.pmean(grad(p, bt, w), ENV_AXIS)

    with jax.default_matmul_precision("highest"):
        g_mesh = jax.device_get(sharded(params, batch, weights))
        dev0 = mesh.devices.flat[0]
        g_one = jax.device_get(jax.jit(grad)(
            jax.device_put(params, dev0), jax.device_put(batch, dev0),
            jax.device_put(weights, dev0)))
    return max(rel_err(a, b) for a, b in zip(jax.tree.leaves(g_mesh), jax.tree.leaves(g_one)))


def data_parallel_run(mesh, cfg, supersteps: int, card: str, label: str) -> float:
    """``DistributedTrainer`` over ``mesh``: shard placement, a replicated
    learner after training, and aggregate env-steps/s."""
    import jax

    from deep_q_learning_tpu.train import DistributedTrainer

    n = mesh.devices.size
    tr = DistributedTrainer(cfg, mesh=mesh).init()
    for name, tree in (("env state", tr.runner.env_states), ("replay", tr.runner.replay.storage)):
        for leaf in jax.tree.leaves(tree):
            devs = {s.device for s in leaf.addressable_shards}
            check(len(leaf.addressable_shards) == n and len(devs) == n,
                  f"{label}: {name} leaf {leaf.shape} has shards on {len(devs)} devices")
    compile_s, _ = compile_trainer(tr)
    res, sps = timed_train(tr, supersteps)
    check(res.env_steps == (1 + supersteps) * cfg.steps_per_superstep * cfg.num_envs,
          f"{label}: env steps {res.env_steps}")
    check(np.isfinite(res.history[-1]["loss"]), f"{label}: loss not finite")
    for leaf in jax.tree.leaves(tr.runner.train.params):
        shards = leaf.addressable_shards
        check(len({s.device for s in shards}) == n, f"{label}: params not on {n} devices")
        first = np.asarray(shards[0].data)
        check(all(bitwise_equal(first, np.asarray(s.data)) for s in shards[1:]),
              f"{label}: learner params differ across devices")
    log(f"  {label}: {sps:,.0f} env-steps/s aggregate ({cfg.num_envs // n} envs per card, "
        f"{n} card(s), {supersteps} supersteps after 1 untimed, compile {compile_s:.1f} s); "
        f"shards on {n} distinct devices; learner bitwise replicated; card {card}")
    return sps


def phase_data_parallel(devices, cfg, card: str, supersteps: int = 4) -> dict:
    """The multi-card path and what it is compared with: ``cfg`` on all of
    ``devices`` and, with the same envs per card, on the first one."""
    import jax

    from deep_q_learning_tpu.parallel import make_env_mesh

    n = len(devices)
    log(f"phase dp: env-sharded data parallelism on {n} devices")
    mesh = make_env_mesh(devices=devices)
    sps_n = data_parallel_run(mesh, cfg, supersteps, card, f"{n} cards")
    one = dataclasses.replace(
        cfg, num_envs=cfg.num_envs // n, batch_size=cfg.batch_size // n,
        buffer_capacity=cfg.buffer_capacity // n)
    sps_1 = data_parallel_run(make_env_mesh(devices=devices[:1]), one, supersteps,
                              card, "1 card")
    from deep_q_learning_tpu.algos.dqn import init_train_state, make_optimizer
    from deep_q_learning_tpu.envs import make_env
    from deep_q_learning_tpu.models import QNetwork

    env, env_params = make_env(cfg.env_id, cfg.time_fraction_obs, cfg.max_steps_in_episode)
    net = QNetwork(num_actions=env.num_actions, hidden=cfg.hidden, dueling=cfg.dueling)
    params = init_train_state(net, make_optimizer(cfg), jax.random.PRNGKey(1),
                              env.obs_shape(env_params)[0]).params
    err = allreduced_vs_single_grad(mesh, cfg, jax.device_get(params),
                                    cfg.batch_size // n)
    log(f"  all-reduced gradient vs one-device gradient over the concatenated "
        f"{cfg.batch_size} rows (highest precision): max rel err {err:.3g} (<= 1e-5)")
    check(err <= 1e-5, f"all-reduced gradient rel err {err:.3g} > 1e-5")
    log(f"  weak-scaling efficiency {sps_n / (n * sps_1):.3f} "
        f"({sps_n:,.0f} vs {n} x {sps_1:,.0f} env-steps/s)")
    return {"sps_n": sps_n, "sps_1": sps_1, "grad_err": err}


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card data-parallel phase")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu" or jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    devices = jax.devices()
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but {len(devices)} GPU(s) visible",
              file=sys.stderr)
        return 2
    devices = devices[:args.cards]

    from deep_q_learning_tpu.utils.compile_cache import enable_compile_cache
    from deep_q_learning_tpu.utils.metrics import gpu_cards

    log("phase 1: device")
    cards = gpu_cards()
    for line in cards:
        log(f"  nvidia-smi: {line}")
    card = cards[0]
    log(f"  jax: {devices[0].platform} {devices[0].device_kind} x{len(devices)}; "
        f"jax {jax.__version__}")
    log(f"  compile cache: {enable_compile_cache()}")

    if args.cards > 1:
        from deep_q_learning_tpu.config import multihost_ddqn

        phase_data_parallel(devices, multihost_ddqn(), card)
    else:
        phase_references(devices[0], jax.devices("cpu")[0])
        phase_main_path(card)

    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
