"""Prioritized experience replay, fully on device.

Net-new capability over the reference (uniform-only,
``replay_buffer.py:68-85``), required by BASELINE.json config 4.  Proportional
PER (Schaul et al. 2015): sample ∝ priority^α, importance weights
``(1/(n·P))^β`` normalized by the batch max, new transitions at max priority,
priorities updated to ``|td|+ε`` after each learner step.

Device layout: priorities live beside the ring storage as a dense
``(num_envs, capacity_per_env)`` array.  Sampling is a two-level categorical —
(1) pick envs ∝ per-env priority sums, (2) pick slots within each chosen env
row — implemented with cumulative sums and rank-by-comparison, which
vectorizes with no host sync and no tree pointer-chasing, and fuses into the
superstep.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from deep_q_learning_tpu import struct

from deep_q_learning_tpu.envs.base import Transition
from deep_q_learning_tpu.replay.uniform import (  # noqa: F401
    ReplayState,
    RingStorage,
    pack_aux,
)


@struct.dataclass
class PrioritizedReplayState:
    storage: RingStorage  # slot-major packed leaves — see replay/uniform.py
    priorities: jax.Array  # (N, C) f32, already exponentiated by alpha
    max_priority: jax.Array  # scalar f32 (pre-alpha magnitude)
    cursor: jax.Array
    total_adds: jax.Array

    @property
    def capacity_per_env(self) -> int:
        return self.storage.aux.shape[0]

    @property
    def num_envs(self) -> int:
        return self.storage.aux.shape[1]

    @property
    def filled(self) -> jax.Array:
        return jnp.minimum(self.total_adds, self.capacity_per_env)


class SampleInfo(NamedTuple):
    env_idx: jax.Array  # (B,)
    slot_idx: jax.Array  # (B,)


class PrioritizedReplay:
    """Functional proportional-PER ring buffer (same write path as uniform)."""

    kind = "prioritized"

    def __init__(
        self,
        num_envs: int,
        capacity_per_env: int,
        alpha: float = 0.6,
        beta: float = 0.4,
        eps: float = 1e-6,
        max_decay: float = 0.999,
        gamma: float = 0.99,
        n_step: int = 1,
        truncation_bootstrap: bool = True,
    ):
        self.num_envs = num_envs
        self.capacity_per_env = capacity_per_env
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        # insertion-priority high-water decay per update; 1.0 = monotone max
        self.max_decay = max_decay
        self.gamma = gamma
        self.n_step = n_step
        self.truncation_bootstrap = truncation_bootstrap

    # ----------------------------------------------------------------- init
    def init(self, example: Transition) -> PrioritizedReplayState:
        # slot-major packed storage — see the layout note in replay/uniform.py.
        # priorities stay env-major (N, C): they are reduced/cumsum'd along
        # the slot axis at sample time; their per-frame column write is tiny.
        assert example.obs.shape[0] == self.num_envs

        def alloc(leaf):
            return jnp.zeros(
                (self.capacity_per_env,) + leaf.shape, leaf.dtype
            )

        storage = RingStorage(
            obs=alloc(example.obs),
            next_obs=alloc(example.next_obs),
            aux=jnp.zeros(
                (self.capacity_per_env, self.num_envs, 4), jnp.float32
            ),
        )
        return PrioritizedReplayState(
            storage=storage,
            priorities=jnp.zeros((self.num_envs, self.capacity_per_env), jnp.float32),
            max_priority=jnp.float32(1.0),
            cursor=jnp.int32(0),
            total_adds=jnp.int32(0),
        )

    # ------------------------------------------------------------------ add
    def add(
        self, state: PrioritizedReplayState, transition: Transition
    ) -> PrioritizedReplayState:
        def write(buf, item):
            return jax.lax.dynamic_update_slice_in_dim(
                buf, item[None], state.cursor, axis=0
            )

        storage = RingStorage(
            obs=write(state.storage.obs, transition.obs),
            next_obs=write(state.storage.next_obs, transition.next_obs),
            aux=write(state.storage.aux, pack_aux(transition)),
        )
        # new transitions enter at max priority (standard PER)
        new_p = jnp.full((self.num_envs, 1), state.max_priority**self.alpha)
        priorities = jax.lax.dynamic_update_slice_in_dim(
            state.priorities, new_p, state.cursor, axis=1
        )
        return state.replace(
            storage=storage,
            priorities=priorities,
            cursor=(state.cursor + 1) % self.capacity_per_env,
            total_adds=state.total_adds + 1,
        )

    # --------------------------------------------------------------- sample
    def sample_indices(
        self, state: PrioritizedReplayState, key: jax.Array, batch_size: int
    ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
        """Two-level proportional draw: ``(env_idx, slot_idx, p_sel, total)``
        where ``p_sel = p[env_idx, slot_idx] / total`` is each draw's
        probability and ``total`` the sum of sampleable priorities."""
        from deep_q_learning_tpu.replay.nstep import valid_slot_mask

        # zero the newest n-1 slots so n-step windows never cross the cursor
        mask = valid_slot_mask(
            self.capacity_per_env, state.cursor, state.filled, self.n_step
        )
        p = state.priorities * mask[None, :].astype(jnp.float32)

        env_key, slot_key = jax.random.split(key)
        # level 1: env rows ∝ row sums.  Rank-by-comparison-sum instead of
        # jnp.searchsorted: the dense compare+reduce is trivial compute and
        # lowers to tiny HLO.
        row_sums = jnp.sum(p, axis=1)  # (N,)
        row_cdf = jnp.cumsum(row_sums)
        total = row_cdf[-1]
        u_env = jax.random.uniform(env_key, (batch_size,)) * total
        env_idx = jnp.sum(
            (row_cdf[None, :] < u_env[:, None]).astype(jnp.int32), axis=1
        )
        env_idx = jnp.minimum(env_idx, self.num_envs - 1)

        # level 2: slot within each chosen row ∝ row priorities
        rows = p[env_idx]  # (B, C) gather
        row_cdfs = jnp.cumsum(rows, axis=1)
        row_tot = row_cdfs[:, -1]
        u_slot = jax.random.uniform(slot_key, (batch_size,)) * row_tot
        slot_idx = jnp.sum(
            (row_cdfs < u_slot[:, None]).astype(jnp.int32), axis=1
        )
        slot_idx = jnp.minimum(slot_idx, self.capacity_per_env - 1)
        p_sel = p[env_idx, slot_idx] / jnp.maximum(total, 1e-12)
        return env_idx, slot_idx, p_sel, total

    def sample_with_info(
        self, state: PrioritizedReplayState, key: jax.Array, batch_size: int,
        gamma=None, beta=None,
    ) -> Tuple[Transition, SampleInfo, jax.Array]:
        """Two-level proportional sampling; returns (batch, info, weights).

        ``gamma`` and ``beta`` may be traced runtime values (HyperParams);
        they default to the constructor's static values."""
        from deep_q_learning_tpu.replay.nstep import assemble_learn_batch

        env_idx, slot_idx, p_sel, _ = self.sample_indices(state, key, batch_size)
        batch = assemble_learn_batch(
            state.storage, env_idx, slot_idx,
            self.gamma if gamma is None else gamma,
            self.n_step, self.truncation_bootstrap,
        )

        # importance weights: w = (1/(n·P))^β, normalized by batch max
        n_valid = (state.filled * self.num_envs).astype(jnp.float32)
        w = (1.0 / jnp.maximum(n_valid * p_sel, 1e-12)) ** (
            self.beta if beta is None else beta
        )
        w = w / jnp.maximum(jnp.max(w), 1e-12)
        return batch, SampleInfo(env_idx, slot_idx), w.astype(jnp.float32)

    # ------------------------------------------------------------- updates
    def update_priorities(
        self,
        state: PrioritizedReplayState,
        info: SampleInfo,
        td_errors: jax.Array,
    ) -> PrioritizedReplayState:
        mag = jnp.abs(td_errors) + self.eps
        new_p = mag**self.alpha
        # Duplicate (env, slot) pairs in one batch are the SAME transition, so
        # their |td| values agree — but XLA scatter with duplicate indices has
        # unspecified which-write-wins.  The update is instead two one-hot
        # matmuls over the batch — values and hit counts.  Duplicates are
        # first resolved to their group MAX via a tiny (B, B) pairwise
        # comparison, and only each group's first row writes, so every
        # output sums at most one nonzero term: the result is exactly the
        # group max — deterministic max-wins, the documented rule
        # (tests/test_per.py::test_update_duplicate_indices).  The matmuls
        # run at HIGHEST precision: a TF32 product would round the written
        # priorities to 10 mantissa bits.  Guarded by the one-hot footprint
        # (B·(N+C) elements): huge-N configs fall back to the set-then-max
        # scatter rather than materializing a multi-hundred-MB env one-hot.
        b = info.env_idx.shape[0]
        if b * (self.num_envs + self.capacity_per_env) <= (1 << 22):
            same = jnp.logical_and(
                info.env_idx[:, None] == info.env_idx[None, :],
                info.slot_idx[:, None] == info.slot_idx[None, :],
            )  # (B, B)
            vmax = jnp.max(
                jnp.where(same, new_p[None, :], -jnp.inf), axis=1
            )  # (B,) group max over duplicate (env, slot) pairs
            first = ~jnp.any(jnp.tril(same, k=-1), axis=1)  # no earlier twin
            slot_oh = (
                info.slot_idx[:, None]
                == jnp.arange(self.capacity_per_env)[None, :]
            ).astype(jnp.float32) * first[:, None]  # (B, C)
            env_oh = (
                info.env_idx[:, None] == jnp.arange(self.num_envs)[None, :]
            ).astype(jnp.float32)  # (B, N)
            hi = jax.lax.Precision.HIGHEST
            values = jnp.matmul(env_oh.T, slot_oh * vmax[:, None], precision=hi)
            hits = jnp.matmul(env_oh.T, slot_oh, precision=hi)  # (N, C)
            priorities = jnp.where(hits > 0, values, state.priorities)
        else:
            priorities = state.priorities.at[info.env_idx, info.slot_idx].set(0.0)
            priorities = priorities.at[info.env_idx, info.slot_idx].max(new_p)
        # Decaying high-water mark: the classic monotone max lets one outlier
        # |td| permanently pin every future insertion priority; decaying it
        # toward the freshest batch max forgets the outlier once the buffer
        # has recycled (max_decay=1.0 restores the monotone behavior).
        return state.replace(
            priorities=priorities,
            max_priority=jnp.maximum(
                state.max_priority * self.max_decay, jnp.max(mag)
            ),
        )

    def can_sample(self, state: PrioritizedReplayState, min_transitions: int) -> jax.Array:
        return (state.filled * self.num_envs) >= min_transitions

    # ----------------------------------------------- learner-mutable view
    # See UniformReplay.learner_view: only these fields may appear in the
    # superstep's learner lax.cond; the ring storage must stay outside it.
    def learner_view(self, state: PrioritizedReplayState):
        return (state.priorities, state.max_priority)

    def with_learner_view(
        self, state: PrioritizedReplayState, view
    ) -> PrioritizedReplayState:
        priorities, max_priority = view
        return state.replace(priorities=priorities, max_priority=max_priority)

    # -------------------------------------------------- mesh-sharding mapping
    def shard_specs(self, example: PrioritizedReplayState, env_axis: str):
        from jax.sharding import PartitionSpec as P

        return PrioritizedReplayState(
            storage=jax.tree.map(lambda _: P(None, env_axis), example.storage),
            priorities=P(env_axis),
            max_priority=P(env_axis),
            cursor=P(env_axis),
            total_adds=P(env_axis),
        )

    def to_local(self, g: PrioritizedReplayState) -> PrioritizedReplayState:
        return PrioritizedReplayState(
            storage=g.storage,
            priorities=g.priorities,
            max_priority=g.max_priority[0],
            cursor=g.cursor[0],
            total_adds=g.total_adds[0],
        )

    def to_global(self, l: PrioritizedReplayState) -> PrioritizedReplayState:
        one = lambda x: jnp.asarray(x)[None]
        return PrioritizedReplayState(
            storage=l.storage,
            priorities=l.priorities,
            max_priority=one(l.max_priority),
            cursor=one(l.cursor),
            total_adds=one(l.total_adds),
        )
