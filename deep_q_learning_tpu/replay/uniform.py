"""Device-resident uniform replay — the device-side rebuild of the reference's
host ring buffer (``/root/reference/General/Base/replay_buffer.py:10-85``).

Reference design: one numpy circular buffer on the host, overwrite-oldest via
``counter % size`` (replay_buffer.py:35-43), and a numba-jitted host sampler
drawing uniform indices **with replacement** (replay_buffer.py:68-85).

Device design: a pytree of device arrays laid out **slot-major** —
``(capacity_per_env, num_envs, ...)`` — a per-env ring with the slot axis
LEADING.  All ``num_envs`` lockstep instances write their transition at the
same slot each step, so the write is a single ``dynamic_update_slice`` of one
contiguous ``(1, num_envs, ...)`` row on axis 0 (no scatter, no conflicts,
fully fused into the jitted actor step).  Sampling draws (env, slot) pairs
with ``jax.random`` on device — with replacement, matching the reference
sampler's semantics.  ``num_envs`` (axis 1) is the mesh's "env" axis, so the
buffer shards with the envs and sampling stays shard-local.

Why slot-major: with env-major ``(num_envs, capacity, ...)`` leaves, the
per-frame ring write updates a dynamic-offset COLUMN — which leaves XLA's
layout assignment torn between the write's preferred layout and the
sample-time gathers', and can reconcile the two with per-frame
layout-conversion copies of the whole ring inside the training loop.
Slot-major writes one contiguous row at a dynamic leading-axis offset.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from deep_q_learning_tpu import struct

from deep_q_learning_tpu.envs.base import Transition


# packed-aux lane indices (RingStorage.aux trailing axis)
AUX_REWARD, AUX_ACTION, AUX_TERM, AUX_TRUNC = 0, 1, 2, 3


@struct.dataclass
class RingStorage:
    """Slot-major transition storage.

    ``obs``/``next_obs`` keep their dtype/feature shape; the four scalar
    fields (reward, action, terminated, truncated) are PACKED into one
    float32 ``aux`` lane axis, so the n-step window is one (B, n, 4)
    gather instead of four scalar gathers, and the n-step assembler reuses
    the window's first column for the start-transition action.  Packing is
    exact: actions are small ints (f32-exact
    to 2^24) and the flags are 0/1.
    """

    obs: jax.Array  # (C, N, *obs_shape)
    next_obs: jax.Array  # (C, N, *obs_shape)
    aux: jax.Array  # (C, N, 4) f32: [reward, action, terminated, truncated]


def pack_aux(transition: Transition) -> jax.Array:
    """(N, 4) f32 packed scalar lane for one vector-step."""
    return jnp.stack(
        [
            transition.reward.astype(jnp.float32),
            transition.action.astype(jnp.float32),
            transition.terminated.astype(jnp.float32),
            transition.truncated.astype(jnp.float32),
        ],
        axis=-1,
    )


def unpack_aux(aux: jax.Array) -> tuple:
    """(reward f32, action i32, terminated bool, truncated bool) from a
    gathered ``(..., 4)`` aux block."""
    return (
        aux[..., AUX_REWARD],
        aux[..., AUX_ACTION].astype(jnp.int32),
        aux[..., AUX_TERM] > 0.5,
        aux[..., AUX_TRUNC] > 0.5,
    )


@struct.dataclass
class ReplayState:
    """Device-resident ring-buffer state.

    ``storage`` leaves have shape ``(capacity_per_env, num_envs, ...)``
    (slot-major — module docstring).  ``cursor`` is the next write slot
    (shared by all envs — lockstep writes); ``total_adds`` counts
    vector-steps written, so ``filled = min(total_adds, capacity)`` (the
    reference's ``num_samples``, replay_buffer.py:41-43).
    """

    storage: RingStorage
    cursor: jax.Array  # int32 scalar
    total_adds: jax.Array  # int32 scalar

    @property
    def capacity_per_env(self) -> int:
        return self.storage.aux.shape[0]

    @property
    def num_envs(self) -> int:
        return self.storage.aux.shape[1]

    @property
    def filled(self) -> jax.Array:
        return jnp.minimum(self.total_adds, self.capacity_per_env)


class UniformReplay:
    """Uniform-sampling per-env ring buffer (functional; all ops jittable)."""

    kind = "uniform"

    def __init__(
        self,
        num_envs: int,
        capacity_per_env: int,
        gamma: float = 0.99,
        n_step: int = 1,
        truncation_bootstrap: bool = True,
    ):
        if capacity_per_env < 1:
            raise ValueError("capacity_per_env must be >= 1")
        if not 1 <= n_step <= capacity_per_env:
            raise ValueError(f"n_step={n_step} out of range for capacity {capacity_per_env}")
        self.num_envs = num_envs
        self.capacity_per_env = capacity_per_env
        self.gamma = gamma
        self.n_step = n_step
        self.truncation_bootstrap = truncation_bootstrap

    # ----------------------------------------------------------------- init
    def init(self, example: Transition) -> ReplayState:
        """Allocate zeroed slot-major packed storage from one example
        batched transition (leaves ``(num_envs, ...)``); only
        shapes/dtypes of leaves are used."""
        assert example.obs.shape[0] == self.num_envs, (
            f"example leaves must be batched (num_envs={self.num_envs}), "
            f"got obs shape {example.obs.shape}"
        )

        def alloc(leaf: jax.Array) -> jax.Array:
            return jnp.zeros((self.capacity_per_env,) + leaf.shape, leaf.dtype)

        storage = RingStorage(
            obs=alloc(example.obs),
            next_obs=alloc(example.next_obs),
            aux=jnp.zeros(
                (self.capacity_per_env, self.num_envs, 4), jnp.float32
            ),
        )
        return ReplayState(
            storage=storage, cursor=jnp.int32(0), total_adds=jnp.int32(0)
        )

    # ------------------------------------------------------------------ add
    def add(self, state: ReplayState, transition: Transition) -> ReplayState:
        """Write one vector-step of transitions (leaves ``(num_envs, ...)``)
        at the cursor slot; overwrite-oldest on wraparound (the reference's
        ``counter % size``, replay_buffer.py:37-40).  Slot-major: one
        contiguous row write per leaf on the leading axis."""

        def write(buf: jax.Array, item: jax.Array) -> jax.Array:
            return jax.lax.dynamic_update_slice_in_dim(
                buf, item[None], state.cursor, axis=0
            )

        storage = RingStorage(
            obs=write(state.storage.obs, transition.obs),
            next_obs=write(state.storage.next_obs, transition.next_obs),
            aux=write(state.storage.aux, pack_aux(transition)),
        )
        return ReplayState(
            storage=storage,
            cursor=(state.cursor + 1) % self.capacity_per_env,
            total_adds=state.total_adds + 1,
        )

    # --------------------------------------------------------------- sample
    def sample(self, state: ReplayState, key: jax.Array, batch_size: int) -> Transition:
        """Uniform with replacement over all filled (env, slot) cells —
        device-side equivalent of the numba sampler (replay_buffer.py:68-85)."""
        env_key, slot_key = jax.random.split(key)
        env_idx = jax.random.randint(env_key, (batch_size,), 0, self.num_envs)
        slot_idx = jax.random.randint(
            slot_key, (batch_size,), 0, jnp.maximum(state.filled, 1)
        )
        s = state.storage
        reward, action, term, trunc = unpack_aux(s.aux[slot_idx, env_idx])
        return Transition(
            obs=s.obs[slot_idx, env_idx],
            action=action,
            reward=reward,
            next_obs=s.next_obs[slot_idx, env_idx],
            terminated=term,
            truncated=trunc,
        )

    def can_sample(self, state: ReplayState, min_transitions: int) -> jax.Array:
        """True once at least ``min_transitions`` total transitions are stored
        (the reference's ``training_start`` gate, q_agent.py:186)."""
        return (state.filled * self.num_envs) >= min_transitions

    # ------------------------------------------------- common replay protocol
    def sample_with_info(
        self, state: ReplayState, key: jax.Array, batch_size: int, gamma=None,
        beta=None,
    ):
        """(LearnBatch, info, importance_weights) — uniform: no info, unit
        weights.  Slots are drawn in AGE order so the n-step window never
        crosses the write cursor (replay/nstep.py).  ``gamma`` may be a traced
        runtime value (HyperParams); defaults to the constructor's.  ``beta``
        (PER importance exponent) is accepted for protocol compatibility and
        ignored — uniform sampling has unit weights."""
        from deep_q_learning_tpu.replay.nstep import assemble_learn_batch

        env_key, slot_key = jax.random.split(key)
        env_idx = jax.random.randint(env_key, (batch_size,), 0, self.num_envs)
        max_rank = jnp.maximum(state.filled - (self.n_step - 1), 1)
        rank = jax.random.randint(slot_key, (batch_size,), 0, max_rank)
        start = jnp.mod(state.cursor - state.filled, self.capacity_per_env)
        slot_idx = jnp.mod(start + rank, self.capacity_per_env)
        batch = assemble_learn_batch(
            state.storage, env_idx, slot_idx,
            self.gamma if gamma is None else gamma,
            self.n_step, self.truncation_bootstrap,
        )
        return batch, None, jnp.ones((batch_size,), jnp.float32)

    def update_priorities(self, state: ReplayState, info, td_errors) -> ReplayState:
        return state  # uniform replay has no priorities

    # ----------------------------------------------- learner-mutable view
    # The superstep's learner lax.cond must only carry what the learner can
    # WRITE: if the ring storage appears inside a cond branch (operand or
    # closure), XLA copies the touched leaves every frame to keep the
    # in-place ring write legal — measured ~800 µs/frame at the cartpole
    # headline shape (algos/superstep.py::_maybe_train).
    def learner_view(self, state: ReplayState):
        """Pytree of the fields the learner may mutate (uniform: none)."""
        return ()

    def with_learner_view(self, state: ReplayState, view) -> ReplayState:
        return state

    # -------------------------------------------------- mesh-sharding mapping
    def shard_specs(self, example: ReplayState, env_axis: str):
        """PartitionSpec pytree: storage sharded on the env axis (axis 1 —
        slot-major layout); scalar counters get one slot per shard (see
        ``parallel/distributed.py``)."""
        from jax.sharding import PartitionSpec as P

        return ReplayState(
            storage=jax.tree.map(lambda _: P(None, env_axis), example.storage),
            cursor=P(env_axis),
            total_adds=P(env_axis),
        )

    def to_local(self, g: ReplayState) -> ReplayState:
        return ReplayState(
            storage=g.storage, cursor=g.cursor[0], total_adds=g.total_adds[0]
        )

    def to_global(self, l: ReplayState) -> ReplayState:
        return ReplayState(
            storage=l.storage,
            cursor=jnp.asarray(l.cursor)[None],
            total_adds=jnp.asarray(l.total_adds)[None],
        )
