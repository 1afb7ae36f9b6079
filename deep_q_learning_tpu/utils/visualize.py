"""Greedy-rollout recording and visualization.

The reference's ``generate_visualization`` (utils.py:43-52) opens a Gym
render window and steps one greedy episode on the host.  Headless GPU hosts
have no display, so the equivalent here is (a) a jitted greedy trajectory
recorder (whole rollout on device, one host fetch) and (b) plot/dump helpers:
a LunarLander flight-path figure and an .npz trajectory dump that any
host-side viewer can replay.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np


def record_trajectory(
    env,
    env_params,
    network,
    params,
    key: jax.Array,
    max_steps: Optional[int] = None,
    extras_fn=None,
    static_fn=None,
) -> Dict[str, np.ndarray]:
    """One greedy episode, recorded fully on device via ``lax.scan``.

    Returns host arrays: obs (T, D), action (T,), reward (T,), done (T,),
    plus ``length`` and ``ret`` (masked to the first termination).

    ``extras_fn(state) -> dict of arrays`` records extra per-step channels
    (e.g. world-frame poses for rendering); ``static_fn(state0) -> dict``
    captures per-episode constants (e.g. the terrain profile)."""
    max_steps = max_steps or env_params.max_steps_in_episode
    reset_key, loop_key = jax.random.split(key)

    @jax.jit
    def rollout(params, reset_key, loop_key):
        obs0, state0 = env.reset(reset_key, env_params)

        def step_fn(carry, step_key):
            obs, state, done = carry
            action = jnp.argmax(network.apply(params, obs[None])[0]).astype(jnp.int32)
            nobs, nstate, reward, term, trunc = env.step(step_key, state, action, env_params)
            now_done = term | trunc
            out = {
                "obs": obs,
                "action": action,
                "reward": jnp.where(done, 0.0, reward),
                "done": now_done,
                "live": ~done,
            }
            if extras_fn is not None:
                out["extras"] = extras_fn(state)
            # freeze the state after the first termination
            keep = lambda new, old: jax.tree.map(
                lambda n, o: jnp.where(done, o, n), new, old
            )
            return (keep(nobs, obs), keep(nstate, state), done | now_done), out

        keys = jax.random.split(loop_key, max_steps)
        _, traj = jax.lax.scan(step_fn, (obs0, state0, jnp.array(False)), keys)
        if static_fn is not None:
            traj["static"] = static_fn(state0)
        return traj

    traj = jax.device_get(rollout(params, reset_key, loop_key))
    live = traj["live"].astype(bool)
    length = int(live.sum())
    out = {
        "obs": traj["obs"][:length],
        "action": traj["action"][:length],
        "reward": traj["reward"][:length],
        "done": traj["done"][:length],
        "length": length,
        "ret": float(traj["reward"][:length].sum()),
    }
    if "extras" in traj:
        for k, v in traj["extras"].items():
            out[f"extra_{k}"] = v[:length]
    if "static" in traj:
        for k, v in traj["static"].items():
            out[f"static_{k}"] = v
    return out


def lander_pose_extras(state) -> Dict[str, jnp.ndarray]:
    """``extras_fn`` for LunarLander: world-frame hull + leg poses (what the
    renderer needs).  Works for both engines; in rigid mode the leg channels
    fall back to the fixed settled offsets."""
    base = {
        "x": state.x,
        "y": state.y,
        "angle": state.angle,
    }
    if state.leg1_body is not None:
        for i, leg in ((1, state.leg1_body), (2, state.leg2_body)):
            base[f"leg{i}_x"] = leg.cx
            base[f"leg{i}_y"] = leg.cy
            base[f"leg{i}_a"] = leg.a
    return base


def lander_static(state) -> Dict[str, jnp.ndarray]:
    """``static_fn`` for LunarLander: the episode's terrain profile."""
    return {"terrain": state.terrain}


def render_lander_animation(
    traj: Dict[str, Any], path: str, fps: int = 25, stride: int = 2
) -> str:
    """Animated replay of a recorded LunarLander trajectory — the headless
    equivalent of the reference's live render window
    (``/root/reference/General/Base/utils.py:43-52`` calls ``env.render()``
    per step; headless hosts have no display, so this draws the recorded rollout
    into a .gif/.mp4 via matplotlib.animation).

    Requires the trajectory to have been recorded with
    ``extras_fn=lander_pose_extras, static_fn=lander_static``.  ``stride``
    subsamples frames (the env runs at 50 fps; stride 2 at fps 25 plays in
    real time).  Writer selection: ffmpeg if available (mp4), else pillow
    (gif)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as manim
    import matplotlib.pyplot as plt
    from matplotlib.patches import Polygon as MplPolygon

    from deep_q_learning_tpu.envs.lander_solver import (
        HULL_VERTS,
        LEG_HH,
        LEG_HW,
    )
    from deep_q_learning_tpu.envs.lunar_lander import CHUNKS, W, H

    if "extra_x" not in traj:
        raise ValueError(
            "trajectory lacks pose channels; record with "
            "extras_fn=lander_pose_extras, static_fn=lander_static"
        )
    terrain = np.asarray(traj["static_terrain"])
    xs = np.linspace(0.0, W, CHUNKS)
    T = len(traj["extra_x"])
    frames = list(range(0, T, max(1, stride)))

    fig, ax = plt.subplots(figsize=(6, 4), dpi=90)
    ax.set_xlim(0, W)
    ax.set_ylim(0, H)
    ax.set_aspect("equal")
    ax.fill_between(xs, 0.0, terrain, color="#555555")
    pad_x = W / 2
    ax.plot(
        [pad_x - 2 * W / (CHUNKS - 1) / 2, pad_x + 2 * W / (CHUNKS - 1) / 2],
        [terrain[CHUNKS // 2]] * 2,
        color="#ffcc00",
        lw=2,
    )
    hull_patch = MplPolygon(np.zeros((len(HULL_VERTS), 2)), closed=True, color="#7a7aff")
    ax.add_patch(hull_patch)
    leg_patches = [
        MplPolygon(np.zeros((4, 2)), closed=True, color="#aa3333") for _ in range(2)
    ]
    for lp in leg_patches:
        ax.add_patch(lp)
    (flame,) = ax.plot([], [], color="orange", lw=3)
    title = ax.set_title("")

    def rot2(a, pts):
        c, s = np.cos(a), np.sin(a)
        return pts @ np.array([[c, s], [-s, c]])

    leg_box = np.array(
        [[-LEG_HW, -LEG_HH], [LEG_HW, -LEG_HH], [LEG_HW, LEG_HH], [-LEG_HW, LEG_HH]]
    )
    hull_pts = np.asarray(HULL_VERTS)
    ret_so_far = np.cumsum(np.asarray(traj["reward"]))

    def draw(i):
        x, y, a = traj["extra_x"][i], traj["extra_y"][i], traj["extra_angle"][i]
        hull_patch.set_xy(rot2(a, hull_pts) + [x, y])
        if "extra_leg1_x" in traj:
            for j, lp in enumerate(leg_patches, start=1):
                lx, ly, la = (
                    traj[f"extra_leg{j}_x"][i],
                    traj[f"extra_leg{j}_y"][i],
                    traj[f"extra_leg{j}_a"][i],
                )
                lp.set_xy(rot2(la, leg_box) + [lx, ly])
        act = int(traj["action"][i])
        if act == 2:  # main engine: draw the plume under the hull
            tipd = rot2(a, np.array([[0.0, -0.6], [0.0, -1.3]])) + [x, y]
            flame.set_data(tipd[:, 0], tipd[:, 1])
        else:
            flame.set_data([], [])
        title.set_text(
            f"step {i}  action {['nop', 'left', 'main', 'right'][act]}  "
            f"return {ret_so_far[i]:.1f}"
        )
        return [hull_patch, *leg_patches, flame, title]

    anim = manim.FuncAnimation(fig, draw, frames=frames, blit=False)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.endswith(".mp4") and manim.writers.is_available("ffmpeg"):
        anim.save(path, writer="ffmpeg", fps=fps)
    else:
        if path.endswith(".mp4"):
            path = path[:-4] + ".gif"
        anim.save(path, writer="pillow", fps=fps)
    plt.close(fig)
    return path


def dump_trajectory(path: str, traj: Dict[str, Any]) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{k: v for k, v in traj.items()})
    return path


def plot_lander_flight(traj: Dict[str, Any], path: str) -> str:
    """Flight-path figure for a LunarLander trajectory: x/y path colored by
    time, altitude & velocity traces, action raster."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    obs = traj["obs"]
    fig, (ax1, ax2, ax3) = plt.subplots(1, 3, figsize=(15, 4))
    t = np.arange(len(obs))
    sc = ax1.scatter(obs[:, 0], obs[:, 1], c=t, s=4, cmap="viridis")
    ax1.axhline(0.0, color="gray", lw=1)
    ax1.set_title(f"flight path (return {traj['ret']:.1f})")
    ax1.set_xlabel("x (helipad-relative)")
    ax1.set_ylabel("y")
    fig.colorbar(sc, ax=ax1, label="step")
    ax2.plot(t, obs[:, 1], label="altitude")
    ax2.plot(t, obs[:, 3], label="v_y")
    ax2.plot(t, obs[:, 4], label="angle")
    ax2.legend()
    ax2.grid(alpha=0.3)
    ax2.set_title("state traces")
    ax3.step(t, traj["action"], where="post", lw=0.8)
    ax3.set_yticks([0, 1, 2, 3], ["nop", "left", "main", "right"])
    ax3.set_title("actions")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
