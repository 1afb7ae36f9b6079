"""n-step return assembly at sample time.

Because the ring buffer stores each env's transitions in consecutive slots
(``replay/uniform.py``), an n-step target needs no separate n-step buffer or
actor-side accumulation (the usual host-framework approach): sampling a
(env, slot) pair and gathering the next ``n`` slots along the capacity axis
yields the forward window in time order.  Auto-reset keeps windows
well-defined — the ``terminated``/``truncated`` flags of the stopping
transition mask out anything past an episode boundary.

    G        = Σ_{k<K} γ^k r_{t+k}            K = steps until first stop (≤ n)
    bootstrap= γ^K · nonterminal_at_stop
    batch    = (s_t, a_t, G, s_{t+K}, bootstrap)

Validity: the window must not cross the write cursor (slots ahead of the
cursor belong to a different wall-clock era).  ``valid_slot_mask`` exposes
the age test used by both buffers (uniform restricts the sampled age range;
PER zeroes the priorities of the newest n-1 slots).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from deep_q_learning_tpu import struct

from deep_q_learning_tpu.envs.base import Transition  # noqa: F401 (API type)


@struct.dataclass
class LearnBatch:
    """What the learner consumes: per-sample n-step return + bootstrap factor
    (γ^K · nonterminal folded together, so the loss is
    ``huber(G + bootstrap · boot_value − Q(s,a))`` for any n)."""

    obs: jax.Array  # (B, D)
    action: jax.Array  # (B,)
    reward: jax.Array  # (B,) n-step discounted return G
    next_obs: jax.Array  # (B, D) state s_{t+K} to bootstrap from
    bootstrap: jax.Array  # (B,) γ^K · (0 if the stop was a true termination)


def valid_slot_mask(
    capacity: int, cursor: jax.Array, filled: jax.Array, n_step: int
) -> jax.Array:
    """(C,) bool: slots whose n-step window lies fully inside the stored,
    time-ordered region (i.e. age rank ≤ filled − n)."""
    start = jnp.mod(cursor - filled, capacity)  # oldest stored slot
    ranks = jnp.mod(jnp.arange(capacity) - start, capacity)
    return ranks < jnp.maximum(filled - (n_step - 1), 0)


def assemble_learn_batch(
    storage,  # RingStorage (replay/uniform.py)
    env_idx: jax.Array,  # (B,)
    slot_idx: jax.Array,  # (B,)
    gamma: float,
    n_step: int,
    truncation_bootstrap: bool,
) -> LearnBatch:
    """Gather the n-slot forward windows and fold them into a LearnBatch.

    Storage is slot-major — leaves ``(capacity, num_envs, ...)``, see
    replay/uniform.py — so all gathers index ``[slot, env]``.  The scalar
    fields live in ONE packed (C, N, 4) f32 lane axis (RingStorage.aux),
    so the whole n-step window is a single (B, n, 4) gather, and the
    start-transition action rides in the window's first column (win[:, 0]
    == slot_idx) — one gather instead of four per-field gathers."""
    from deep_q_learning_tpu.replay.uniform import (
        AUX_ACTION,
        AUX_REWARD,
        AUX_TERM,
        AUX_TRUNC,
    )

    capacity = storage.aux.shape[0]
    b = env_idx.shape[0]

    # (B, n) window slots along the capacity axis
    offsets = jnp.arange(n_step)
    win = jnp.mod(slot_idx[:, None] + offsets[None, :], capacity)
    env2 = jnp.broadcast_to(env_idx[:, None], (b, n_step))

    aux_win = storage.aux[win, env2]  # (B, n, 4) — one gather for all scalars
    rewards = aux_win[..., AUX_REWARD]  # (B, n)
    term = aux_win[..., AUX_TERM]  # stored as f32 0/1
    trunc = aux_win[..., AUX_TRUNC]
    stop = jnp.clip(term + trunc, 0.0, 1.0)

    # alive_k = 1 iff no stop among transitions 0..k-1 (the stopping
    # transition itself is still included)
    alive = jnp.cumprod(
        jnp.concatenate([jnp.ones((b, 1)), 1.0 - stop[:, :-1]], axis=1), axis=1
    )  # (B, n)

    discounts = gamma ** offsets.astype(jnp.float32)  # (n,)
    g = jnp.sum(alive * discounts[None, :] * rewards, axis=1)

    k = jnp.sum(alive, axis=1)  # (B,) float: number of included steps
    last_off = (k - 1.0).astype(jnp.int32)
    last_slot = jnp.mod(slot_idx + last_off, capacity)

    # was the stop (if any, within the window) a true termination?
    stopped_term = jnp.sum(alive * term, axis=1)
    stopped_trunc = jnp.sum(alive * trunc, axis=1)
    if truncation_bootstrap:
        nonterm = 1.0 - stopped_term
    else:  # ref-compat: truncation also cuts the bootstrap (q_agent.py:179-180)
        nonterm = 1.0 - jnp.clip(stopped_term + stopped_trunc, 0.0, 1.0)

    bootstrap = (gamma**k) * nonterm

    return LearnBatch(
        obs=storage.obs[slot_idx, env_idx],
        action=aux_win[:, 0, AUX_ACTION].astype(jnp.int32),
        reward=g.astype(jnp.float32),
        next_obs=storage.next_obs[last_slot, env_idx],
        bootstrap=bootstrap.astype(jnp.float32),
    )
