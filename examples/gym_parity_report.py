"""Generate artifacts/gym_parity.json — the measured fidelity report.

Round-1 VERDICT item 1: run the Box2D cross-check and produce real numbers
(per-step state divergence for CartPole and LunarLander, heuristic-controller
return distributions on both engines, impact-speed crash boundaries).  The
DQN learning-curve overlay lives in artifacts/curves/ (see
``examples/engine_curve_compare.py`` + ``examples/summarize_engine_curves.py``).

Run on CPU:
    JAX_PLATFORMS=cpu python examples/gym_parity_report.py
"""

from __future__ import annotations

import json


def impact_sweep_box2d(speeds, seed=0):
    """Vertical drop onto the pad at controlled impact speed on Box2D."""
    import gymnasium as gym

    out = {}
    for v0 in speeds:
        env = gym.make("LunarLander-v3").unwrapped
        env.reset(seed=seed)
        L = env.lander
        for _ in range(80):  # settle legs at joint limits while held aloft
            env.step(0)
            for b in [L] + list(env.legs):
                b.linearVelocity = (0, 0)
                b.angularVelocity = 0
        lowest = min(
            leg.GetWorldPoint(v).y
            for leg in env.legs
            for v in leg.fixtures[0].shape.vertices
        )
        y0 = env.helipad_y * 0.99 + (L.position.y - lowest) + 0.03
        dx, dy = 10.0 - L.position.x, y0 - L.position.y
        for b in [L] + list(env.legs):
            b.position = (b.position.x + dx, b.position.y + dy)
            b.linearVelocity = (0, -v0)
            b.angularVelocity = 0
        r = None
        for _ in range(400):
            obs, r, term, trunc, _ = env.step(0)
            if term:
                break
        out[str(v0)] = "CRASH" if env.game_over else ("LAND" if r == 100 else "TIMEOUT")
    return out


def impact_sweep_jax(speeds, jointed=True):
    """Same protocol as the Box2D sweep: settle the legs aloft, teleport the
    whole assembly to just above the pad, release at controlled speed."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from deep_q_learning_tpu.envs import LunarLander, lander_solver as ls
    from deep_q_learning_tpu.envs.lunar_lander import HELIPAD_Y, LEG_TIP_Y, CONTACT_SKIN, W

    env = LunarLander()
    p = env.default_params().replace(random_terrain=False, jointed=jointed)
    step = jax.jit(env.step)
    out = {}
    ground = 0.99 * HELIPAD_Y
    for v0 in speeds:
        _, st = env.reset(jax.random.PRNGKey(0), p)
        if jointed:
            # settle the legs at the joint limits while held aloft (the b2
            # sweep does the same 80-frame hold with velocities zeroed)
            zero = jnp.float32(0.0)
            for t in range(80):
                _, st, *_ = step(jax.random.PRNGKey(t), st, jnp.int32(0), p)
                st = st.replace(
                    vx=zero, vy=zero, omega=zero,
                    leg1_body=st.leg1_body._replace(vx=zero, vy=zero, w=zero),
                    leg2_body=st.leg2_body._replace(vx=zero, vy=zero, w=zero),
                )
            corners = []
            for leg in (st.leg1_body, st.leg2_body):
                for sx in (-1.0, 1.0):
                    for sy in (-1.0, 1.0):
                        wx, wy = ls.rot(leg.a, sx * ls.LEG_HW, sy * ls.LEG_HH)
                        corners.append(float(leg.cy + wy))
            lowest = min(corners)
            y0 = ground + (float(st.y) - lowest) + 0.03
            dx, dy = W / 2 - float(st.x), y0 - float(st.y)
            move = lambda b: b._replace(
                cx=b.cx + dx, cy=b.cy + dy,
                vx=zero, vy=jnp.float32(-v0), w=zero,
            )
            st = st.replace(
                x=st.x + dx, y=st.y + dy,
                vx=zero, vy=jnp.float32(-v0), omega=zero,
                leg1_body=move(st.leg1_body),
                leg2_body=move(st.leg2_body),
                sleep=jnp.int32(0),
            )
        else:
            st = st.replace(
                x=jnp.float32(W / 2),
                y=jnp.float32(ground + CONTACT_SKIN - LEG_TIP_Y + 0.03),
                vx=jnp.float32(0.0),
                vy=jnp.float32(-v0),
                angle=jnp.float32(0.0),
                omega=jnp.float32(0.0),
                leg1=jnp.array(False),
                leg2=jnp.array(False),
                sleep=jnp.int32(0),
            )
        r = None
        for t in range(400):
            _, st, r, term, trunc = step(jax.random.PRNGKey(t), st, jnp.int32(0), p)
            if bool(term):
                break
        rr = float(r)
        out[str(v0)] = "CRASH" if rr == -100.0 else ("LAND" if rr == 100.0 else "TIMEOUT")
    return out


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")

    from deep_q_learning_tpu.envs import gym_compat as gc
    from deep_q_learning_tpu.envs import lunar_lander as ll

    from deep_q_learning_tpu.envs import lander_solver as ls

    report = {"engine": "jointed (envs/lander_solver.py, round 3)"}
    report["cartpole_stepwise"] = [
        gc.compare_cartpole(num_steps=300, seed=s) for s in range(5)
    ]
    # nop/burn are open-loop (deterministic action sequences); the heuristic
    # is CLOSED-loop per engine — open-loop replay of a powered descent
    # measures chaos amplification, not engine error (gym_compat docstring)
    for pol in ("nop", "burn"):
        report[f"lunar_stepwise_{pol}"] = [
            gc.compare_lunar_stepwise(policy=pol, seed=s) for s in range(10)
        ]
    report["lunar_stepwise_heuristic"] = [
        gc.compare_lunar_stepwise(
            policy="heuristic", seed=s, max_steps=1000, closed_loop=True
        )
        for s in range(10)
    ]
    # wind/turbulence ON (VERDICT r4 missing #3): gymnasium v3's
    # deterministic tanh(sin) pattern, phase-matched via injected counters
    report["lunar_stepwise_wind"] = [
        gc.compare_lunar_stepwise(
            policy=pol, seed=s, enable_wind=True, max_steps=1000
        )
        for pol in ("nop", "burn")
        for s in range(6)
    ]
    report["lunar_task_level"] = gc.compare_lunar_task_level(episodes=20, seed=0)
    speeds = [0.5, 1.0, 1.5, 1.8, 2.0, 2.2, 2.5, 3.0, 4.0]
    report["impact_sweep"] = {
        "box2d": impact_sweep_box2d(speeds),
        "jax": impact_sweep_jax(speeds, jointed=True),
        "jax_rigid": impact_sweep_jax(speeds, jointed=False),
    }
    report["constants"] = {
        "note": "measured by instantiating gymnasium's Box2D bodies",
        "hull_mass": ls.HULL_M,
        "hull_inertia": ls.HULL_I,
        "hull_center": [ls.HULL_CX, ls.HULL_CY],
        "leg_mass": ls.LEG_M,
        "leg_inertia": ls.LEG_I,
        "total_mass": ll.TOTAL_MASS,
        "assembly_inertia_rigid": ll.INERTIA,
        "contact_skin": ll.CONTACT_SKIN,
        "mu": ll.MU,
        "j_crash_rigid": ll.J_CRASH,
        "sleep": [ll.LIN_SLEEP_TOL, ll.ANG_SLEEP_TOL, ll.SLEEP_FRAMES],
    }
    with open("artifacts/gym_parity.json", "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(report["lunar_task_level"], indent=1))
    print("impact:", json.dumps(report["impact_sweep"]))
    print("wrote artifacts/gym_parity.json")


if __name__ == "__main__":
    main()
