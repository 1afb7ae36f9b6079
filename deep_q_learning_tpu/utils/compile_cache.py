"""Where JAX's persistent compilation cache lives.

Entry points (the CLI, ``bench.py``, ``chip_smoke.py``) call
:func:`enable_compile_cache` before their first compile, so a later process
that builds the same program loads its executable from disk instead of
compiling it again.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory.

    ``$JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and is
    left alone.  Otherwise the cache is the checkout's fixed ``.jax_cache``:
    the path is part of each entry's key, so it must not move between runs."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
