"""Metrics, logging, plots, and timing.

Reference equivalents (SURVEY.md §5.1, §5.5, §2 #4/#16):
  * ``print`` every 50 episodes (q_agent.py:214-217)      -> JSONL metric log
  * matplotlib reward plot at solve (q_agent.py:233-246)  -> ``plot_history``
  * broken loss-history path (q_agent.py:128-132 — nothing ever appended)
    -> loss is recorded from the actual train step every superstep
  * ``stop_time`` wall-clock helper, defined but never used (utils.py:13-18)
    -> ``stopwatch`` context manager + ``trace`` jax.profiler annotation
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time
from typing import Dict, Iterable, List, Optional


class MetricLogger:
    """Append-only JSONL metric stream (one record per logged superstep)."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self.records: List[Dict] = []
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        else:
            self._fh = None

    def log(self, record: Dict) -> None:
        self.records.append(record)
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
        if self.echo:
            print(record, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


def plot_history(
    history: Iterable[Dict],
    path: str,
    x_key: str = "env_steps",
    y_keys: Iterable[str] = ("window_mean", "loss"),
) -> str:
    """Reward/loss curves (the reference's ``_plot``, q_agent.py:233-246 —
    with the loss curve actually populated)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    history = list(history)
    y_keys = list(y_keys)
    fig, axes = plt.subplots(len(y_keys), 1, figsize=(8, 3 * len(y_keys)), sharex=True)
    if len(y_keys) == 1:
        axes = [axes]
    xs = [r[x_key] for r in history]
    for ax, key in zip(axes, y_keys):
        ax.plot(xs, [r.get(key, float("nan")) for r in history])
        ax.set_ylabel(key)
        ax.grid(True, alpha=0.3)
    axes[-1].set_xlabel(x_key)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def gpu_cards() -> List[str]:
    """``name, power.limit`` of every visible NVIDIA card, one line each, as
    ``nvidia-smi`` prints them.  A card may be set below its maximum power
    limit and then runs slower under load, so every timing names both."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


@contextlib.contextmanager
def stopwatch(name: str, sink=print):
    """Wall-clock timer (the reference's never-called ``stop_time``,
    utils.py:13-18, as a context manager that is actually usable)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink(f"{name}: {time.perf_counter() - t0:.3f}s")


@contextlib.contextmanager
def trace(name: str):
    """jax.profiler annotation around a phase (shows up in TensorBoard/xprof
    traces); safe no-op if profiling isn't active."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


def start_profiler_trace(logdir: str) -> None:
    import jax

    jax.profiler.start_trace(logdir)


def stop_profiler_trace() -> None:
    import jax

    jax.profiler.stop_trace()
