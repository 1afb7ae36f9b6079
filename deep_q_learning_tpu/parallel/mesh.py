"""Device mesh + process setup.

The reference has no distributed capability at all (SURVEY.md §2: single
process, single device).  The framework's scale axis is the environment
instance dimension: env state, replay, and episode accounting shard over a 1-D
``("env",)`` mesh; the Q-network learner is replicated and its gradients
all-reduce inside the jitted superstep (``parallel/distributed.py``).  The
cards of one host are joined all to all, so the mesh follows the algorithm
alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENV_AXIS = "env"


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> None:
    """Multi-host process bootstrap (``jax.distributed.initialize``).

    Three launch modes:
      * single-process (the common case on one host / in tests): call with no
        arguments — initialization errors from missing coordinator env vars
        are swallowed and the process runs standalone;
      * a cluster whose launcher JAX recognizes (e.g. SLURM): call with no
        arguments on each host; jax auto-detects the coordinator;
      * explicit multi-process (including the CPU-backend multi-process tests,
        ``tests/test_multiprocess.py``): pass ``coordinator_address``
        ("host:port"), ``num_processes`` and ``process_id`` — after this,
        ``jax.devices()`` spans every process (cross-process CPU collectives
        ride Gloo; GPU collectives, NCCL).

    Idempotent: a second call on an already-initialized runtime is a no-op.
    """
    # NOTE: must not touch jax.process_count()/jax.devices() here — any
    # backend-initialising call before jax.distributed.initialize() is an
    # error.  Detect "already initialized" via the distributed client state.
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return  # already initialized
    explicit = coordinator_address is not None
    if explicit:
        kwargs.update(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError) as e:
        if "already" in str(e).lower():
            return
        if explicit:
            raise  # a requested multi-process launch must not silently degrade
        # single-process launch without coordinator env vars: fine


def make_env_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the env axis (defaults to every visible device)."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    import numpy as np

    return Mesh(np.asarray(devices), (ENV_AXIS,))


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding for env-dimension arrays."""
    return NamedSharding(mesh, P(ENV_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
