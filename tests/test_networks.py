"""Q-network tests: dueling-head algebra (ref ``dddqn.py:29-31``), feature
output, and bf16 compute path."""

import jax
import jax.numpy as jnp
import numpy as np

from deep_q_learning_tpu.models import QNetwork


def test_dueling_head_algebra():
    """Q = V + A - mean(A) implies mean_a(Q) == V: check via the params."""
    net = QNetwork(num_actions=4, hidden=(8, 8), dueling=True)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((2, 5)))
    x = jax.random.normal(jax.random.PRNGKey(1), (7, 5))
    q, feats = net.apply(params, x, return_features=True)
    assert q.shape == (7, 4) and feats.shape == (7, 8)
    # reconstruct V from the value head directly
    v = feats @ params["params"]["value"]["kernel"] + params["params"]["value"]["bias"]
    np.testing.assert_allclose(
        np.asarray(jnp.mean(q, axis=1)), np.asarray(v[:, 0]), rtol=1e-5, atol=1e-6
    )


def test_non_dueling_head():
    net = QNetwork(num_actions=3, hidden=(8,), dueling=False)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))
    q = net.apply(params, jnp.ones((5, 4)))
    assert q.shape == (5, 3)
    assert q.dtype == jnp.float32


def test_bf16_compute_dtype_outputs_f32():
    net = QNetwork(num_actions=4, hidden=(16, 16), compute_dtype=jnp.bfloat16)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)))
    q = net.apply(params, jax.random.normal(jax.random.PRNGKey(1), (3, 8)))
    assert q.dtype == jnp.float32
    # close to the f32 computation
    net32 = QNetwork(num_actions=4, hidden=(16, 16), compute_dtype=jnp.float32)
    q32 = net32.apply(params, jax.random.normal(jax.random.PRNGKey(1), (3, 8)))
    np.testing.assert_allclose(np.asarray(q), np.asarray(q32), rtol=0.05, atol=0.05)


def test_param_tree_names_shapes_and_init():
    """The tree the checkpoint converter and population vmap rely on, and
    the initialisers: LeCun-normal kernels (std 1/sqrt(fan_in), truncated at
    2 std) and zero biases."""
    net = QNetwork(num_actions=4, hidden=(256, 128), dueling=True)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 64)))
    p = params["params"]
    shapes = {k: (v["kernel"].shape, v["bias"].shape) for k, v in p.items()}
    assert shapes == {
        "trunk_0": ((64, 256), (256,)),
        "trunk_1": ((256, 128), (128,)),
        "value": ((128, 1), (1,)),
        "advantage": ((128, 4), (4,)),
    }
    for name, fan_in in (("trunk_0", 64), ("trunk_1", 256)):
        k = np.asarray(p[name]["kernel"])
        assert k.dtype == np.float32
        np.testing.assert_allclose(k.std(), 1.0 / np.sqrt(fan_in), rtol=0.05)
        assert abs(k.mean()) < 0.1 / np.sqrt(fan_in)
        # truncated normal: nothing beyond 2 std of the untruncated normal
        assert np.abs(k).max() <= 2.0 / 0.8796 / np.sqrt(fan_in) + 1e-6
        assert not np.asarray(p[name]["bias"]).any()
    assert set(QNetwork(2, (8,), dueling=False).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3)))["params"]) == {"trunk_0", "q"}


def test_init_matches_flax_dense_values():
    """A seed draws the same weights the Flax ``linen.Dense`` version of this
    network drew (values recorded from it), so recipes tuned on it start
    from the same point."""
    p = QNetwork(num_actions=3, hidden=(8,), dueling=True).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4)))["params"]
    np.testing.assert_array_equal(
        np.asarray(p["trunk_0"]["kernel"])[0],
        np.float32([0.28240716457366943, 0.6184131503105164, 0.39542344212532043,
                    0.23748061060905457, -0.27868226170539856, 0.4938834011554718,
                    0.3882492184638977, -0.18626751005649567]),
    )
    np.testing.assert_array_equal(
        np.asarray(p["value"]["kernel"])[0], np.float32([0.19265665113925934]))
    np.testing.assert_array_equal(
        np.asarray(p["advantage"]["kernel"])[0],
        np.float32([0.27594977617263794, 0.5456088185310364, 0.21446259319782257]),
    )
