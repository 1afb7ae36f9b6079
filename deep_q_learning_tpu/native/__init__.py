"""Native (C++) host runtime components, bound via ctypes.

The device compute path is pure JAX/XLA; these components cover the
*host* side of the framework where native code earns its keep — currently
the replay ring buffer + uniform sampler used by the host-compat training
loop (``compat/host_loop.py``), the native analog of the reference's
numba-jitted sampler (``replay_buffer.py:68-85``).

The shared library is compiled from source with g++ on first use and cached
beside the source; everything degrades gracefully (ImportError) when no
compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "replay_buffer.cc")
_LIB = os.path.join(os.path.dirname(__file__), "libreplay.so")
_lib: Optional[ctypes.CDLL] = None


def _build_library() -> str:
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    # build beside the target, then rename: concurrent first uses (test
    # workers) never load a half-written library
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)
    return _LIB


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build_library())
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_size.restype = ctypes.c_int64
    lib.rb_size.argtypes = [ctypes.c_void_p]
    lib.rb_capacity.restype = ctypes.c_int64
    lib.rb_capacity.argtypes = [ctypes.c_void_p]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.rb_add.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_int32, ctypes.c_float, f32p, ctypes.c_uint8,
    ]
    lib.rb_add_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, f32p, i32p, f32p, f32p, u8p,
    ]
    lib.rb_sample.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, f32p, i32p, f32p, f32p, u8p,
    ]
    _lib = lib
    return lib


class HostReplayBuffer:
    """numpy-facing wrapper over the C++ ring buffer.

    Mirrors the reference ``ReplayBuffer`` + ``sample_batch`` semantics
    (preallocated circular storage, overwrite-oldest, uniform sampling with
    replacement) with the hot loops in compiled C++ instead of numba."""

    def __init__(self, capacity: int, obs_dim: int, seed: int = 0):
        self._lib = load_library()
        self._handle = self._lib.rb_create(capacity, obs_dim, seed)
        self.capacity = capacity
        self.obs_dim = obs_dim

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.rb_destroy(self._handle)
            self._handle = None

    @property
    def size(self) -> int:
        return self._lib.rb_size(self._handle)

    def add(self, obs, action: int, reward: float, next_obs, done: bool) -> None:
        self._lib.rb_add(
            self._handle,
            np.ascontiguousarray(obs, np.float32),
            int(action),
            float(reward),
            np.ascontiguousarray(next_obs, np.float32),
            int(bool(done)),
        )

    def add_batch(self, obs, action, reward, next_obs, done) -> None:
        obs = np.ascontiguousarray(obs, np.float32)
        n = obs.shape[0]
        self._lib.rb_add_batch(
            self._handle,
            n,
            obs,
            np.ascontiguousarray(action, np.int32),
            np.ascontiguousarray(reward, np.float32),
            np.ascontiguousarray(next_obs, np.float32),
            np.ascontiguousarray(done, np.uint8),
        )

    def sample(self, batch_size: int) -> Tuple[np.ndarray, ...]:
        obs = np.empty((batch_size, self.obs_dim), np.float32)
        action = np.empty((batch_size,), np.int32)
        reward = np.empty((batch_size,), np.float32)
        next_obs = np.empty((batch_size, self.obs_dim), np.float32)
        done = np.empty((batch_size,), np.uint8)
        self._lib.rb_sample(
            self._handle, batch_size, obs, action, reward, next_obs, done
        )
        return obs, action, reward, next_obs, done.astype(bool)
