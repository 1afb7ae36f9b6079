"""Loss/target semantics tests over LearnBatch.

Checks the vectorized TD machinery against (a) optax's huber, (b) an
independent per-sample transcription of the reference's target formula
(``q_learning_functions.py:57-60``), and (c) gradient-equivalence between the
reference's full-vector huber regression (``:31-39``) and our
gather-at-action loss."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from deep_q_learning_tpu.replay.nstep import LearnBatch
from deep_q_learning_tpu.algos.losses import build_loss_fn, huber, td_targets


def test_huber_matches_optax():
    err = jnp.linspace(-3, 3, 31)
    np.testing.assert_allclose(
        np.asarray(huber(err)), np.asarray(optax.huber_loss(err)), rtol=1e-6
    )


def test_td_targets_double_vs_vanilla():
    key = jax.random.PRNGKey(0)
    q_on = jax.random.normal(key, (5, 3))
    q_tg = jax.random.normal(jax.random.PRNGKey(1), (5, 3))
    r = jnp.arange(5, dtype=jnp.float32)
    gamma = 0.9
    bootstrap = gamma * jnp.array([1, 1, 0, 1, 0], jnp.float32)

    t_double = td_targets(q_on, q_tg, r, bootstrap, double=True)
    t_vanilla = td_targets(q_on, q_tg, r, bootstrap, double=False)

    for i in range(5):
        a_star = int(jnp.argmax(q_on[i]))
        expect_d = float(r[i] + bootstrap[i] * q_tg[i, a_star])
        expect_v = float(r[i] + bootstrap[i] * jnp.max(q_tg[i]))
        np.testing.assert_allclose(float(t_double[i]), expect_d, rtol=1e-6)
        np.testing.assert_allclose(float(t_vanilla[i]), expect_v, rtol=1e-6)
    # terminal rows: target is just the reward
    np.testing.assert_allclose(np.asarray(t_double)[[2, 4]], np.asarray(r)[[2, 4]], rtol=1e-6)


def _linear_apply(params, x):
    return x @ params["w"] + params["b"]


def _make_batch(key, b=16, d=6, a=4, gamma=0.9, term_p=0.3):
    ks = jax.random.split(key, 5)
    terminated = jax.random.bernoulli(ks[4], term_p, (b,))
    return LearnBatch(
        obs=jax.random.normal(ks[0], (b, d)),
        action=jax.random.randint(ks[1], (b,), 0, a),
        reward=jax.random.normal(ks[2], (b,)),
        next_obs=jax.random.normal(ks[3], (b, d)),
        bootstrap=gamma * (1.0 - terminated.astype(jnp.float32)),
    )


def _make_params(key, d=6, a=4):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    params = {"w": jax.random.normal(k1, (d, a)), "b": jax.random.normal(k2, (a,))}
    target = {"w": jax.random.normal(k3, (d, a)), "b": jax.random.normal(k4, (a,))}
    return params, target


def test_ref_formula_transcription():
    """The ref_terminal_quirk path must equal a direct per-sample evaluation
    of the reference's formula: target_val = r + (1-d)(γ·q_tm[a*] - q[a]);
    q_target[a] = q[a] + target_val."""
    params, target = _make_params(jax.random.PRNGKey(0))
    batch = _make_batch(jax.random.PRNGKey(1), gamma=0.9)
    loss_fn = build_loss_fn(_linear_apply, double=True, ref_terminal_quirk=True)
    _, td_err = loss_fn(params, target, batch, jnp.ones((16,)))

    q = _linear_apply(params, batch.obs)
    nq = _linear_apply(params, batch.next_obs)
    nq_tm = _linear_apply(target, batch.next_obs)
    for i in range(16):
        a = int(batch.action[i])
        d = 0.0 if float(batch.bootstrap[i]) > 0 else 1.0
        a_star = int(jnp.argmax(nq[i]))
        target_val = float(batch.reward[i]) + (1 - d) * (
            0.9 * float(nq_tm[i, a_star]) - float(q[i, a])
        )
        expect_err = (float(q[i, a]) + target_val) - float(q[i, a])
        np.testing.assert_allclose(float(td_err[i]), expect_err, rtol=1e-4, atol=1e-5)


def test_gather_loss_equals_full_vector_regression_gradients():
    """The reference regresses the full A-dim Q vector against a target equal
    to Q everywhere but the taken action (q_learning_functions.py:31-39 + 59).
    That is gradient-identical to our gather-at-action loss when the target is
    stopped — verify on a linear model."""
    params, target = _make_params(jax.random.PRNGKey(2))
    batch = _make_batch(jax.random.PRNGKey(3), gamma=0.9)

    loss_fn = build_loss_fn(_linear_apply, double=True)

    def ours(p):
        loss, _ = loss_fn(p, target, batch, jnp.ones((16,)))
        return loss

    def full_vector(p):
        q = _linear_apply(p, batch.obs)
        nq = jax.lax.stop_gradient(_linear_apply(p, batch.next_obs))
        nq_tm = _linear_apply(target, batch.next_obs)
        a_star = jnp.argmax(nq, axis=1)
        boot = jnp.take_along_axis(nq_tm, a_star[:, None], 1)[:, 0]
        scalar_t = batch.reward + batch.bootstrap * boot
        q_taken = jnp.take_along_axis(q, batch.action[:, None], 1)[:, 0]
        delta = jax.lax.stop_gradient(scalar_t) - jax.lax.stop_gradient(q_taken)
        q_target = jax.lax.stop_gradient(q) + delta[:, None] * jax.nn.one_hot(
            batch.action, 4
        )
        return jnp.mean(jnp.sum(optax.huber_loss(q, q_target), axis=1))

    g_ours = jax.grad(ours)(params)
    g_ref = jax.grad(full_vector)(params)
    np.testing.assert_allclose(
        np.asarray(g_ours["w"]), np.asarray(g_ref["w"]), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(g_ours["b"]), np.asarray(g_ref["b"]), rtol=1e-4, atol=1e-5
    )


def test_terminal_vs_bootstrap_errors():
    """bootstrap=0 rows regress exactly toward the reward."""
    params, target = _make_params(jax.random.PRNGKey(4))
    batch = _make_batch(jax.random.PRNGKey(5), term_p=1.0)  # all terminal
    loss_fn = build_loss_fn(_linear_apply)
    _, err = loss_fn(params, target, batch, jnp.ones((16,)))
    q = _linear_apply(params, batch.obs)
    q_taken = np.take_along_axis(np.asarray(q), np.asarray(batch.action)[:, None], 1)[:, 0]
    np.testing.assert_allclose(
        np.asarray(err), np.asarray(batch.reward) - q_taken, rtol=1e-5, atol=1e-6
    )


def _q_batch(b=64, a=4, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    q_s, q_no, q_nt = (f32(rng.normal(size=(b, a)) * 2) for _ in range(3))
    action = rng.integers(0, a, size=b).astype(np.int32)
    reward = f32(rng.normal(size=b) * 3)
    bootstrap = f32(0.97 * (rng.random(b) > 0.25))
    weights = f32(rng.random(b) + 0.1)
    return q_s, q_no, q_nt, action, reward, bootstrap, weights


def _loss_on_q(double, loss, delta=1.0):
    """The repo's loss fed Q-values directly: the "network" picks one half of
    a (B, 2A) input (online params [1, 0], target params [0, 1])."""
    fn = build_loss_fn(
        lambda p, x: p[0] * x[:, : x.shape[1] // 2] + p[1] * x[:, x.shape[1] // 2:],
        double=double, loss=loss, huber_delta=delta,
    )

    def run(q_s, q_no, q_nt, action, reward, bootstrap, weights):
        batch = LearnBatch(
            obs=jnp.concatenate([q_s, jnp.zeros_like(q_s)], 1), action=action,
            reward=reward, next_obs=jnp.concatenate([q_no, q_nt], 1),
            bootstrap=bootstrap,
        )
        return fn(jnp.array([1.0, 0.0]), jnp.array([0.0, 1.0]), batch, weights)

    return run


@pytest.mark.parametrize("loss", ["huber", "mse"])
@pytest.mark.parametrize("double", [True, False])
def test_plain_loss_matches_float64_reference(double, loss):
    q_s, q_no, q_nt, action, reward, bootstrap, weights = _q_batch()
    got_loss, got_td = _loss_on_q(double, loss)(
        q_s, q_no, q_nt, action, reward, bootstrap, weights)
    f64 = lambda x: np.asarray(x, np.float64)
    rows = np.arange(len(action))
    boot = (f64(q_nt)[rows, np.argmax(q_no, 1)] if double else f64(q_nt).max(1))
    td = f64(reward) + f64(bootstrap) * boot - f64(q_s)[rows, action]
    if loss == "huber":
        per = np.where(np.abs(td) <= 1.0, 0.5 * td**2, np.abs(td) - 0.5)
    else:
        per = 0.5 * td**2
    np.testing.assert_allclose(np.asarray(got_td), td, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got_loss), np.mean(f64(weights) * per), rtol=1e-5)


@pytest.mark.parametrize("double", [True, False])
def test_huber_gradient_rule(double):
    """dL/dQ(s, a) = -w · clip(td, ±δ) / B at the taken action, 0 elsewhere
    (targets are stopped), for δ = 1 and δ = 0.5."""
    q_s, q_no, q_nt, action, reward, bootstrap, weights = _q_batch(seed=1)
    for delta in (1.0, 0.5):
        run = _loss_on_q(double, "huber", delta)
        dq, td = jax.grad(
            lambda q: run(q, q_no, q_nt, action, reward, bootstrap, weights),
            has_aux=True,
        )(jnp.asarray(q_s))
        want = np.zeros_like(q_s)
        rows = np.arange(len(action))
        want[rows, action] = -weights * np.clip(np.asarray(td), -delta, delta) / len(action)
        np.testing.assert_allclose(np.asarray(dq), want, rtol=1e-6, atol=1e-9)


def test_huber_gradient_clips_large_errors():
    """In the linear regime |td| > δ every sample's gradient magnitude is
    exactly w·δ/B: outliers cannot dominate the update."""
    q_s, q_no, q_nt, action, reward, bootstrap, weights = _q_batch(seed=2)
    reward = reward + 100.0
    run = _loss_on_q(True, "huber", 1.0)
    dq, td = jax.grad(
        lambda q: run(q, q_no, q_nt, action, reward, bootstrap, weights), has_aux=True
    )(jnp.asarray(q_s))
    assert float(jnp.min(jnp.abs(td))) > 1.0
    taken = np.asarray(dq)[np.arange(len(action)), action]
    np.testing.assert_allclose(-taken, weights / len(action), rtol=1e-6)
