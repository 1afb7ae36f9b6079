"""deep_q_learning_tpu — a device-resident deep Q-learning framework.

Built from scratch against the capability surface of
``hal9000universe/deep-q-learning`` (see SURVEY.md), re-architected
device-first: pure-JAX vectorized environments, replay in device memory, a
fused jitted actor-learner superstep, and mesh-sharded scaling over the
"env" axis.
"""

__version__ = "0.1.0"

import os as _os

if _os.environ.get("DQL_PRNG", "threefry") == "rbg":
    # Opt-in rbg PRNG: the superstep draws per-frame keys for 1000s of envs
    # and threefry2x32 is a software cipher.  Streams differ from threefry
    # (same distributions, still reproducible run-to-run), so it is
    # env-gated rather than silently default.
    import jax as _jax

    _jax.config.update("jax_default_prng_impl", "rbg")

from deep_q_learning_tpu.config import DQNConfig, PRESETS
