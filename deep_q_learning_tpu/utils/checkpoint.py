"""Checkpoint / resume.

The reference pickles ``(params, opt_state)`` every ``back_up_frequency``
episodes (``/root/reference/General/Base/utils.py:21-40``) and has **no
mid-training resume** — buffer, ε, and counters are lost on crash
(SURVEY.md §5.3-5.4).  Here the FULL runner state (params, target params,
optimizer state, env states, replay buffer contents, RNG, every counter) is
one pytree, written as the flattened leaves of that pytree (one ``.npz``) and
restored exactly — training resumes bit-identically.

A pickle-compat layer reproduces the reference's on-disk format
(``<dir>/params.pickle`` + ``<dir>/opt_state.pickle``) for users migrating
from it.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import multihost_utils

_LEAVES = "leaves.npz"
_META = "meta.json"


# ---------------------------------------------------------------------------
# Full-state checkpoints
# ---------------------------------------------------------------------------

def _to_host(leaf: Any) -> np.ndarray:
    """Whole value of one leaf on this host (collective for leaves sharded
    over devices of other processes: every process must call it)."""
    if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
        return np.asarray(multihost_utils.process_allgather(leaf, tiled=True))
    return np.asarray(leaf)


def save_checkpoint(path: str, state: Any, step: int) -> str:
    """Save a pytree checkpoint under ``path/<step>``; returns the dir.

    Every process calls this; process 0 writes.  The directory appears
    complete or not at all (written beside it, then renamed)."""
    path = os.path.abspath(path)
    ckpt_dir = os.path.join(path, str(step))
    leaves, treedef = jax.tree.flatten(state)
    host = [_to_host(x) for x in leaves]
    if jax.process_index() == 0:
        os.makedirs(path, exist_ok=True)
        tmp = ckpt_dir + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        # raw bytes: np.savez cannot round-trip extension dtypes (bfloat16)
        np.savez(
            os.path.join(tmp, _LEAVES),
            **{
                str(i): np.ascontiguousarray(a).reshape(-1).view(np.uint8)
                for i, a in enumerate(host)
            },
        )
        meta = {
            "treedef": str(treedef),
            "shapes": [list(a.shape) for a in host],
            "dtypes": [str(a.dtype) for a in host],
        }
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        os.replace(tmp, ckpt_dir)
    if jax.process_count() > 1:
        multihost_utils.sync_global_devices(f"save_checkpoint:{ckpt_dir}")
    return ckpt_dir


def restore_checkpoint(path: str, target: Any, step: int | None = None) -> Any:
    """Restore from ``path/<step>`` (or the latest step dir if None) into the
    structure of ``target`` (an example pytree, e.g. a fresh runner state).

    Leaves come back with ``target``'s shardings.  A checkpoint whose tree,
    shapes or dtypes differ from ``target`` raises ``ValueError``."""
    path = os.path.abspath(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    ckpt_dir = os.path.join(path, str(step))
    with open(os.path.join(ckpt_dir, _META)) as f:
        meta = json.load(f)
    leaves, treedef = jax.tree.flatten(target)
    if meta["treedef"] != str(treedef):
        raise ValueError(
            f"checkpoint {ckpt_dir} holds a different state tree than the "
            f"restore target:\n  saved:  {meta['treedef']}\n  target: {treedef}"
        )
    out = []
    with np.load(os.path.join(ckpt_dir, _LEAVES)) as z:
        for i, leaf in enumerate(leaves):
            shape, dtype = tuple(meta["shapes"][i]), meta["dtypes"][i]
            want = (tuple(np.shape(leaf)), str(np.result_type(leaf)))
            if (shape, dtype) != want:
                raise ValueError(
                    f"checkpoint {ckpt_dir} leaf {i}: saved {dtype}{list(shape)}, "
                    f"target {want[1]}{list(want[0])}"
                )
            arr = z[str(i)].view(jnp.dtype(dtype)).reshape(shape)
            if isinstance(leaf, jax.Array):
                out.append(
                    jax.make_array_from_callback(
                        shape, leaf.sharding, lambda idx, a=arr: a[idx]
                    )
                )
            else:
                out.append(arr)
    return jax.tree.unflatten(treedef, out)


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = sorted(
        int(d) for d in os.listdir(path)
        if d.isdigit() and os.path.exists(os.path.join(path, d, _META))
    )
    return steps[-1] if steps else None


# ---------------------------------------------------------------------------
# Reference pickle-format compatibility (utils.py:21-40)
# ---------------------------------------------------------------------------

def save_params_pickle(directory: str, params: Any, opt_state: Any) -> None:
    """Write ``params.pickle`` / ``opt_state.pickle`` exactly like the
    reference's ``generate_saving`` closure (utils.py:21-29), with device
    arrays materialized to numpy for portability."""
    os.makedirs(directory, exist_ok=True)
    host = lambda tree: jax.tree.map(np.asarray, tree)
    with open(os.path.join(directory, "params.pickle"), "wb") as f:
        pickle.dump(host(params), f)
    with open(os.path.join(directory, "opt_state.pickle"), "wb") as f:
        pickle.dump(host(opt_state), f)


def _reconstruct_legacy_device_array(fun, args, arr_state=None, aval_state=None):
    """Rebuild a jax<=0.3-era ``DeviceArray`` pickle payload as numpy.

    jax 0.3's ``jax._src.device_array.reconstruct_device_array(fun, args,
    arr_state, aval_state)`` rebuilt the numpy value then ``device_put`` it;
    here we stop at the host value (callers decide about devices)."""
    value = fun(*args)
    if arr_state is not None:
        value.__setstate__(arr_state)
    return np.asarray(value)


class _LegacyUnpickler(pickle.Unpickler):
    """Unpickler for checkpoints written by old jax/haiku stacks.

    Maps the jax-0.3-era ``jax._src.device_array`` / ``jax.interpreters.xla``
    reconstruction entry points (modules deleted in modern jax) onto a
    numpy-materializing shim; haiku ``FlatMap``/immutable dicts degrade to
    plain dicts.  Everything else resolves normally."""

    _DEVICE_ARRAY_FNS = {
        ("jax._src.device_array", "reconstruct_device_array"),
        ("jax.interpreters.xla", "reconstruct_device_array"),
        ("jax.interpreters.xla", "_reconstruct_device_array"),
    }

    def find_class(self, module, name):
        if (module, name) in self._DEVICE_ARRAY_FNS:
            return _reconstruct_legacy_device_array
        if module.startswith("haiku") and name in ("FlatMap", "FlatMapping", "frozendict"):
            return dict
        return super().find_class(module, name)


def load_params_pickle(directory: str):
    """Read the reference's pickle pair (utils.py:32-40), including the
    repository's committed jax-0.3-era artifacts
    (``/root/reference/Test/lunar_lander/params.pickle``)."""
    with open(os.path.join(directory, "params.pickle"), "rb") as f:
        params = _LegacyUnpickler(f).load()
    with open(os.path.join(directory, "opt_state.pickle"), "rb") as f:
        opt_state = _LegacyUnpickler(f).load()
    return params, opt_state


def haiku_to_flax_params(hk_params, hidden_layers: int):
    """Convert a reference (Haiku) ``Model`` param dict to this framework's
    ``QNetwork`` structure (the tree Flax's ``linen.Dense`` layers used).

    The reference model (``/root/reference/LunarLander/dddqn.py:11-34``)
    creates, in order: trunk Linear(32), Linear(64), value Linear(1),
    advantage Linear(A) — Haiku names them ``model/~/linear``..``linear_3``
    by creation order.  QNetwork names: ``trunk_i``, ``value``,
    ``advantage`` (``models/networks.py``).  ``hidden_layers`` = number of
    trunk layers (2 for the reference).
    """

    def _index(key: str) -> int:
        tail = key.rsplit("linear", 1)[-1]
        return int(tail.lstrip("_")) if tail else 0

    layers = sorted(
        (k for k in hk_params if "linear" in k.rsplit("/", 1)[-1]), key=_index
    )
    out = {}
    for i, k in enumerate(layers[:hidden_layers]):
        out[f"trunk_{i}"] = {
            "kernel": jnp.asarray(hk_params[k]["w"]),
            "bias": jnp.asarray(hk_params[k]["b"]),
        }
    heads = layers[hidden_layers:]
    if len(heads) == 1:
        out["q"] = {
            "kernel": jnp.asarray(hk_params[heads[0]]["w"]),
            "bias": jnp.asarray(hk_params[heads[0]]["b"]),
        }
    else:
        # dueling: the 1-wide output is the value head (dddqn.py:21-22)
        h0, h1 = heads
        if np.shape(hk_params[h0]["w"])[-1] == 1:
            val_k, adv_k = h0, h1
        else:
            val_k, adv_k = h1, h0
        out["value"] = {
            "kernel": jnp.asarray(hk_params[val_k]["w"]),
            "bias": jnp.asarray(hk_params[val_k]["b"]),
        }
        out["advantage"] = {
            "kernel": jnp.asarray(hk_params[adv_k]["w"]),
            "bias": jnp.asarray(hk_params[adv_k]["b"]),
        }
    return {"params": out}
