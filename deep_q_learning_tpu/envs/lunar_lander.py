"""LunarLander dynamics in pure JAX (Box2D-free, Box2D-calibrated).

The reference trains on Gym's ``LunarLander-v2`` (Box2D on the host,
``/root/reference/Test/lunar_lander.py:44``); every env step is a host call
(``q_agent.py:177``).  This module re-implements the task as pure jittable
JAX so thousands of landers step in lockstep on the accelerator.

Fidelity contract (round 2 — checked against gymnasium's canonical Box2D
implementation, ``gymnasium/envs/box2d/lunar_lander.py``):

  * **Exact** (same formulas, same constants): world geometry (FPS 50,
    SCALE 30, 600x400 viewport, helipad at H/4), terrain generation
    (CHUNKS+1 uniform heights on [0, H/2], helipad substitution across the
    center 5 indices *before* the 3-tap 0.33 smoothing — including the
    published quirks that the pad floor therefore sits at 0.99*H/4 and the
    left edge wraps via Python negative indexing), observation layout and
    normalization, shaping reward, fuel costs (-0.30/-0.03 per frame),
    engine impulse vectors INCLUDING dispersion noise geometry and the
    side-engine 17-vs-14 impulse-position quirk, the initial random force
    on reset, reset's internal nop step (the first observation already has
    one physics frame applied), wind/turbulence (v3's deterministic
    tanh(sin) pattern gated on leg contact — MEASURED r5 with phase-matched
    counters: burn flights with wind ON track Box2D to 1.7e-5..8e-4 obs
    units with exact terminal frames on 6/6 seeds, i.e. within the no-wind
    envelope; gated in tests/test_gym_parity.py::test_lunar_wind_*), and
    semi-implicit Euler integration at dt = 1/50.

  * **Measured from Box2D** (constants extracted by instantiating the real
    bodies; see docstring of each constant): hull mass 4.8167 (density 5 x
    hull polygon area 867 px^2), total assembly mass 4.9589, composite
    rotational inertia 0.953 about the assembly COM, COM offset 0.0981
    above the body origin, settled leg-tip contact points at
    (+-0.8577, -0.6127) in the hull frame, contact skin 0.019 (Box2D
    polygon/edge radius), ground-leg friction mu = sqrt(0.1*0.2).

  * **Two physics engines** (``params.jointed``, config
    ``DQNConfig.lander_engine``):

    - ``jointed`` (default, round 3): the REAL 3-body assembly — hull + two
      legs on motorized revolute joints — stepped by a faithful port of
      Box2D 2.3.5's sequential-impulse solver (``envs/lander_solver.py``:
      motor/limit/point joint constraints, 2-point block contact solver,
      warm-started accumulators, Baumgarte position correction with the b2
      early exit).  Crash-vs-land emerges from joint loading exactly as on
      Box2D.  Measured (artifacts/gym_parity.json, matched-state runs):
      nop-drop flight error <= ~8e-5 obs units on clean seeds, terminal
      reward sign 10/10, term_step within +-2 on 8/10; closed-loop
      heuristic terminal sign 9/10.

    - ``rigid`` (round 2): one rigid body with two leg-tip contacts and a
      calibrated joint-overload threshold (J_CRASH, from the Box2D
      vertical-drop sweep).  ~8x cheaper per frame; kept for
      throughput-calibrated training presets.  Free flight tracks Box2D to
      ~1e-3; touchdown outcomes can flip near the crash boundary.

    Box2D's sleep (the +100 "rest" trigger) uses the real tolerances in
    both engines (0.01 linear, 2 deg/s angular, 0.5 s timer).

Fixed-seed trajectories are exactly reproducible within this env (jit vs
jit, bitwise; tested).  Step-level Box2D parity is measured, not assumed:
``envs/gym_compat.py`` injects matched initial states and reports per-step
divergence; ``tests/test_gym_parity.py`` gates the envelope in CI.
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp
from deep_q_learning_tpu import struct

from deep_q_learning_tpu.envs.base import Environment, EnvParams
import deep_q_learning_tpu.envs.lander_solver as lander_solver
from deep_q_learning_tpu.envs.lander_solver import Body

# ----------------------------- published spec constants --------------------
FPS = 50.0
SCALE = 30.0
VIEWPORT_W = 600.0
VIEWPORT_H = 400.0
W = VIEWPORT_W / SCALE  # 20.0
H = VIEWPORT_H / SCALE  # 13.333
CHUNKS = 11
HELIPAD_Y = H / 4.0

MAIN_ENGINE_POWER = 13.0
SIDE_ENGINE_POWER = 0.6
MAIN_ENGINE_Y_LOCATION = 4.0  # px; nozzle offset below the body origin
INITIAL_RANDOM = 1000.0  # reset force magnitude (applied for one frame)

LEG_AWAY = 20.0 / SCALE
LEG_DOWN = 18.0 / SCALE
LEG_H = 8.0 / SCALE
SIDE_ENGINE_HEIGHT = 14.0 / SCALE
SIDE_ENGINE_AWAY = 12.0 / SCALE

# ------------------- constants measured from the Box2D bodies --------------
# (hull fixture: LANDER_POLY at density 5 -> b2Body.mass/inertia/localCenter;
# legs: 2x8 px boxes at density 1; assembly values from mass-weighted sums at
# the settled leg pose.  See artifacts/gym_parity.json "constants" section.)
HULL_MASS = 4.8167  # b2 lander.mass
TOTAL_MASS = 4.9589  # hull + 2 legs
INERTIA = 0.953  # composite inertia about the assembly COM
COM_OFFSET = 0.0981  # assembly COM above the body origin (body frame y)
LEG_TIP_X = 0.8577  # settled leg lowest-corner offset from body origin
LEG_TIP_Y = -0.6127
CONTACT_SKIN = 0.019  # b2 polygon+edge radius: legs rest this high above ground
HULL_BOTTOM = (-17.0 / SCALE, 17.0 / SCALE, -10.0 / SCALE)  # corners (x1,x2,y)
MU = 0.14142  # sqrt(ground 0.1 x leg 0.2) Box2D friction mixing
J_CRASH = 6.3  # per-leg normal impulse (N*s) above which the joint gives way
# (calibrated on the Box2D vertical-drop sweep in artifacts/gym_parity.json:
# LAND at <=2.0 m/s impact, CRASH at >=2.2 — this threshold reproduces the
# same boundary; a touchdown at v puts ~TOTAL_MASS*(v+g*dt)/2 through each leg)
SLOP = 0.005  # b2_linearSlop: contacts persist within this band (no flicker)
LIN_SLEEP_TOL = 0.01  # b2_linearSleepTolerance
ANG_SLEEP_TOL = 0.0349  # b2_angularSleepTolerance (2 deg/s)
SLEEP_FRAMES = 25  # b2_timeToSleep 0.5 s at 50 FPS
SOLVER_ITERS = 4


@struct.dataclass
class LunarLanderState:
    x: jax.Array  # hull body-origin world position (gym's lander.position)
    y: jax.Array
    vx: jax.Array  # COM linear velocity (gym's lander.linearVelocity)
    vy: jax.Array
    angle: jax.Array
    omega: jax.Array
    leg1: jax.Array  # bool: contact at start of last step (gym BeginContact)
    leg2: jax.Array
    terrain: jax.Array  # (CHUNKS,) smoothed surface heights
    prev_shaping: jax.Array
    t: jax.Array
    sleep: jax.Array  # consecutive below-tolerance frames (Box2D sleep timer)
    wind_idx: jax.Array
    torque_idx: jax.Array
    # jointed mode (params.jointed): the two leg rigid bodies of the 3-body
    # assembly (lander_solver.Body of per-env scalars) and the solver's
    # warm-start accumulators (load-bearing; see lander_solver docstring).
    # None in rigid mode.
    leg1_body: Any = None
    leg2_body: Any = None
    solver_acc: Any = None


@struct.dataclass
class LunarLanderParams(EnvParams):
    gravity: float = -10.0
    random_terrain: bool = struct.field(pytree_node=False, default=True)
    enable_wind: bool = struct.field(pytree_node=False, default=False)
    wind_power: float = 15.0
    turbulence_power: float = 1.5
    dispersion_scale: float = 1.0  # scales engine dispersion noise (1 = spec)
    max_steps_in_episode: int = struct.field(pytree_node=False, default=1000)
    # --- physics engine selection (static: changes the traced program) -----
    # jointed=True runs the Box2D-exact 3-body assembly (hull + 2 legs on
    # motorized revolute joints, lander_solver.py) — crash-vs-land emerges
    # from joint loading like the real env.  False = round-2's single rigid
    # body with the calibrated J_CRASH threshold (faster, approximate).
    jointed: bool = struct.field(pytree_node=False, default=True)
    # sequential-impulse iteration counts.  gym passes (180, 60) to
    # world.Step; the 3-body island converges far earlier, so training
    # presets may lower these — but not below ~60 velocity iterations, where
    # the joints give way under touchdown load (fidelity boundary measured
    # in tests/test_lander_solver.py).
    vel_iters: int = struct.field(pytree_node=False, default=180)
    pos_iters: int = struct.field(pytree_node=False, default=60)
    # velocity-loop convergence early exit (accumulator-impulse delta).
    # 0.0 = Box2D-exact fixed-count loop (the parity-gate mode AND every
    # preset).  The early exit is NOT a batch fast path: measured r5, ~25%
    # of real-training lanes never converge below 1e-4 (the joint motor
    # corrects <~0.1%/iteration), so the vmapped while_loop exits on the
    # slowest lane and runs SLOWER than the fixed loop (config.py
    # lander_vel_tol comment).
    vel_tol: float = struct.field(pytree_node=False, default=0.0)


def _terrain_height(terrain: jax.Array, x: jax.Array) -> jax.Array:
    """Piecewise-linear terrain height at world x (chunks span [0, W]).

    Lookup is a one-hot contraction, not an index gather
    (lander_solver._onehot_pick)."""
    chunk_w = W / (CHUNKS - 1)
    xi = jnp.clip(x / chunk_w, 0.0, CHUNKS - 1 - 1e-6)
    i0 = jnp.floor(xi).astype(jnp.int32)
    frac = xi - i0.astype(jnp.float32)
    h0 = lander_solver._onehot_pick(terrain, i0)
    h1 = lander_solver._onehot_pick(terrain, jnp.minimum(i0 + 1, CHUNKS - 1))
    return h0 * (1.0 - frac) + h1 * frac


def _wind_pattern(idx: jax.Array) -> jax.Array:
    """gymnasium v3's deterministic wind: tanh(sin(2kx) + sin(pi kx)), k=0.01."""
    f = idx.astype(jnp.float32)
    return jnp.tanh(jnp.sin(0.02 * f) + jnp.sin(jnp.pi * 0.01 * f))


class LunarLander(Environment[LunarLanderState, LunarLanderParams]):
    """LunarLander task in pure JAX; see module docstring for fidelity."""

    def default_params(self) -> LunarLanderParams:
        return LunarLanderParams()

    @property
    def num_actions(self) -> int:
        return 4

    def obs_shape(self, params: LunarLanderParams) -> Tuple[int, ...]:
        return (8,)

    # ------------------------------------------------------------------ reset
    def reset_env(self, key: jax.Array, params: LunarLanderParams):
        terrain_key, kick_key, wind_key, step_key = jax.random.split(key, 4)
        # CHUNKS+1 raw heights; helipad substituted BEFORE smoothing; the
        # 3-tap window wraps at the left edge exactly like gym's height[i-1]
        # at i=0 (Python negative indexing reads height[CHUNKS]).
        raw = jax.random.uniform(
            terrain_key, (CHUNKS + 1,), minval=0.0, maxval=H / 2.0
        )
        if not params.random_terrain:
            raw = jnp.full((CHUNKS + 1,), HELIPAD_Y)
        center = CHUNKS // 2
        idx = jnp.arange(CHUNKS + 1)
        raw = jnp.where(jnp.abs(idx - center) <= 2, HELIPAD_Y, raw)
        prev = raw[jnp.arange(-1, CHUNKS - 1)]  # height[i-1], wrapping to [-1]
        nxt = raw[jnp.arange(1, CHUNKS + 1)]  # height[i+1]
        terrain = 0.33 * (prev + raw[:CHUNKS] + nxt)

        kick = jax.random.uniform(
            kick_key, (2,), minval=-INITIAL_RANDOM, maxval=INITIAL_RANDOM
        )
        widx = jax.random.randint(wind_key, (2,), -9999, 9999)

        def make_leg(side):
            # gym: position (initial_x - i*LEG_AWAY/SCALE, initial_y), angle
            # i*0.05 — the joint then PULLS the leg to the hull over the
            # first frames (the anchors start ~0.63 apart; that snap + the
            # swing to the joint limits is real gym behavior).
            return Body(
                cx=jnp.float32(W / 2.0 - side * LEG_AWAY),
                cy=jnp.float32(H),
                a=jnp.float32(side * 0.05),
                vx=jnp.float32(0.0),
                vy=jnp.float32(0.0),
                w=jnp.float32(0.0),
            )

        state = LunarLanderState(
            x=jnp.float32(W / 2.0),
            y=jnp.float32(H),
            vx=jnp.float32(0.0),
            vy=jnp.float32(0.0),
            angle=jnp.float32(0.0),
            omega=jnp.float32(0.0),
            leg1=jnp.array(False),
            leg2=jnp.array(False),
            terrain=terrain,
            prev_shaping=jnp.float32(0.0),
            t=jnp.int32(0),
            sleep=jnp.int32(0),
            wind_idx=widx[0],
            torque_idx=widx[1],
            leg1_body=make_leg(-1.0) if params.jointed else None,
            leg2_body=make_leg(1.0) if params.jointed else None,
            solver_acc=lander_solver.zero_acc() if params.jointed else None,
        )
        # gym's reset ends with `return self.step(0)[0]`: the first obs has
        # one physics frame applied, with the INITIAL_RANDOM force acting on
        # that frame only (ApplyForceToCenter before the first world.Step).
        phys = self._physics_step_jointed if params.jointed else self._physics_step
        state, _, _ = phys(step_key, state, jnp.int32(0), params, kick_force=kick)
        state = state.replace(prev_shaping=self._shaping(state, params), t=jnp.int32(0))
        return self.get_obs(state, params), state

    # ------------------------------------------------------------------- obs
    def get_obs(self, state: LunarLanderState, params: LunarLanderParams) -> jax.Array:
        return jnp.stack(
            [
                (state.x - W / 2.0) / (W / 2.0),
                (state.y - (HELIPAD_Y + LEG_DOWN)) / (H / 2.0),
                state.vx * (W / 2.0) / FPS,
                state.vy * (H / 2.0) / FPS,
                state.angle,
                20.0 * state.omega / FPS,
                state.leg1.astype(jnp.float32),
                state.leg2.astype(jnp.float32),
            ]
        ).astype(jnp.float32)

    def _shaping(self, state: LunarLanderState, params: LunarLanderParams) -> jax.Array:
        """The published potential, computed on the normalized observation."""
        o = self.get_obs(state, params)
        return (
            -100.0 * jnp.sqrt(o[0] ** 2 + o[1] ** 2)
            - 100.0 * jnp.sqrt(o[2] ** 2 + o[3] ** 2)
            - 100.0 * jnp.abs(o[4])
            + 10.0 * o[6]
            + 10.0 * o[7]
        )

    # ---------------------------------------------------------------- physics
    def _physics_step(self, key, state, action, params, kick_force=None):
        """One Box2D-ordered frame: impulses -> gravity -> contact velocity
        solve (at the start-of-step pose, = Box2D's collide phase) ->
        integrate -> position correction.  Returns (state', game_over, rest)
        with leg flags/sleep updated; reward/termination live in step_env."""
        dt = 1.0 / FPS
        sin_a = jnp.sin(state.angle)
        cos_a = jnp.cos(state.angle)
        # gym: tip = (sin, cos) is the body-up direction in world coords;
        # side = (-cos, sin) points along the body's lateral axis.
        tip0, tip1 = sin_a, cos_a
        side0, side1 = -cos_a, sin_a

        comx = state.x - COM_OFFSET * sin_a
        comy = state.y + COM_OFFSET * cos_a
        vx, vy, omega = state.vx, state.vy, state.omega

        # dispersion is drawn every frame (gym draws before the engine gate)
        disp = (
            jax.random.uniform(key, (2,), minval=-1.0, maxval=1.0)
            / SCALE
            * params.dispersion_scale
        )

        # wind/turbulence (v3: deterministic pattern, gated on leg contact)
        wind_idx, torque_idx = state.wind_idx, state.torque_idx
        if params.enable_wind:
            airborne = jnp.logical_not(state.leg1 | state.leg2)
            wind = _wind_pattern(wind_idx) * params.wind_power
            torq = _wind_pattern(torque_idx) * params.turbulence_power
            vx = vx + jnp.where(airborne, wind / TOTAL_MASS * dt, 0.0)
            omega = omega + jnp.where(airborne, torq / INERTIA * dt, 0.0)
            wind_idx = wind_idx + airborne.astype(jnp.int32)
            torque_idx = torque_idx + airborne.astype(jnp.int32)

        # --- main engine (gym's exact impulse geometry) --------------------
        m_power = jnp.where(action == 2, 1.0, 0.0)
        k_main = MAIN_ENGINE_Y_LOCATION / SCALE + 2.0 * disp[0]
        ox_m = tip0 * k_main + side0 * disp[1]
        oy_m = -tip1 * k_main - side1 * disp[1]
        jmx = -ox_m * MAIN_ENGINE_POWER * m_power
        jmy = -oy_m * MAIN_ENGINE_POWER * m_power
        rmx = (state.x + ox_m) - comx  # impulse applied at position + (ox,oy)
        rmy = (state.y + oy_m) - comy
        vx = vx + jmx / TOTAL_MASS
        vy = vy + jmy / TOTAL_MASS
        omega = omega + (rmx * jmy - rmy * jmx) / INERTIA

        # --- side engines ---------------------------------------------------
        s_power = jnp.where((action == 1) | (action == 3), 1.0, 0.0)
        direction = jnp.where(action == 3, 1.0, jnp.where(action == 1, -1.0, 0.0))
        k_side = 3.0 * disp[1] + direction * SIDE_ENGINE_AWAY
        ox_s = tip0 * disp[0] + side0 * k_side
        oy_s = -tip1 * disp[0] - side1 * k_side
        jsx = -ox_s * SIDE_ENGINE_POWER * s_power
        jsy = -oy_s * SIDE_ENGINE_POWER * s_power
        # the published 17-vs-14 impulse-position quirk, reproduced verbatim
        rsx = (state.x + ox_s - tip0 * 17.0 / SCALE) - comx
        rsy = (state.y + oy_s + tip1 * SIDE_ENGINE_HEIGHT) - comy
        vx = vx + jsx / TOTAL_MASS
        vy = vy + jsy / TOTAL_MASS
        omega = omega + (rsx * jsy - rsy * jsx) / INERTIA

        # --- reset kick (one frame) + gravity -------------------------------
        if kick_force is not None:
            vx = vx + kick_force[0] * dt / TOTAL_MASS
            vy = vy + kick_force[1] * dt / TOTAL_MASS
        vy = vy + params.gravity * dt

        # --- contacts at the start-of-step pose (Box2D collide phase) ------
        def leg_tip(sign):
            bx, by = sign * LEG_TIP_X, LEG_TIP_Y
            return (
                state.x + bx * cos_a - by * sin_a,
                state.y + bx * sin_a + by * cos_a,
            )

        p1x, p1y = leg_tip(-1.0)
        p2x, p2y = leg_tip(1.0)
        g1 = _terrain_height(state.terrain, p1x)
        g2 = _terrain_height(state.terrain, p2x)
        c1 = p1y <= g1 + CONTACT_SKIN + SLOP
        c2 = p2y <= g2 + CONTACT_SKIN + SLOP

        # leg-joint give-way (the real Box2D crash mechanism) is an IMPULSE
        # overload through the revolute joint, not a velocity: a pivoting
        # slap carries far less momentum than a vertical slam at the same
        # tip speed.  Checked after the solve below against J_CRASH.

        # --- fixed-iteration impulse solve --------------------------------
        # Normal pair via Box2D's 2-point BLOCK solver (b2ContactSolver):
        # sequential per-point Gauss-Seidel is asymmetric and sustains a
        # rocking limit cycle at rest; the block solve (a 2x2 LCP enumerated
        # over its 4 complementarity cases) is what Box2D actually runs for
        # a 2-point manifold.  Friction stays sequential, clamped by the
        # accumulated normal impulses.
        r1x, r1y = p1x - comx, p1y - comy
        r2x, r2y = p2x - comx, p2y - comy
        a11 = 1.0 / TOTAL_MASS + r1x * r1x / INERTIA
        a22 = 1.0 / TOTAL_MASS + r2x * r2x / INERTIA
        a12 = 1.0 / TOTAL_MASS + r1x * r2x / INERTIA
        det = a11 * a22 - a12 * a12
        mt1 = 1.0 / (1.0 / TOTAL_MASS + r1y * r1y / INERTIA)
        mt2 = 1.0 / (1.0 / TOTAL_MASS + r2y * r2y / INERTIA)
        jn1 = jn2 = jt1 = jt2 = jnp.float32(0.0)
        f1 = c1.astype(jnp.float32)
        f2 = c2.astype(jnp.float32)
        for _ in range(SOLVER_ITERS):
            # normal block solve on ACCUMULATED impulses (restitution 0)
            un1 = vy + omega * r1x
            un2 = vy + omega * r2x
            # normal speeds if the accumulated impulses were removed
            b1 = un1 - (a11 * jn1 + a12 * jn2)
            b2 = un2 - (a12 * jn1 + a22 * jn2)
            # case 1: both contacts active (x = -A^-1 b)
            x1_b = (-a22 * b1 + a12 * b2) / det
            x2_b = (a12 * b1 - a11 * b2) / det
            ok_b = c1 & c2 & (x1_b >= 0.0) & (x2_b >= 0.0)
            # case 2: only contact 1 pushes
            x1_1 = jnp.maximum(-b1 / a11, 0.0) * f1
            ok_1 = c1 & (a12 * x1_1 + b2 >= 0.0) | jnp.logical_not(c2)
            # case 3: only contact 2 pushes
            x2_2 = jnp.maximum(-b2 / a22, 0.0) * f2
            x1 = jnp.where(ok_b, x1_b, jnp.where(ok_1, x1_1, 0.0)) * f1
            x2 = jnp.where(ok_b, x2_b, jnp.where(ok_1, 0.0, x2_2)) * f2
            d1, d2 = x1 - jn1, x2 - jn2
            vy = vy + (d1 + d2) / TOTAL_MASS
            omega = omega + (d1 * r1x + d2 * r2x) / INERTIA
            jn1, jn2 = x1, x2
            # contact 1: friction, clamped by the accumulated normal impulse
            ut = vx - omega * r1y
            jt_new = jnp.clip(jt1 - ut * mt1, -MU * jn1, MU * jn1)
            djt = (jt_new - jt1) * f1
            vx = vx + djt / TOTAL_MASS
            omega = omega - djt * r1y / INERTIA
            jt1 = jt1 + djt
            # contact 2: friction
            ut = vx - omega * r2y
            jt_new = jnp.clip(jt2 - ut * mt2, -MU * jn2, MU * jn2)
            djt = (jt_new - jt2) * f2
            vx = vx + djt / TOTAL_MASS
            omega = omega - djt * r2y / INERTIA
            jt2 = jt2 + djt

        # joint overload: per-frame normal impulse through either leg above
        # what the joint assembly absorbs (calibrated on Box2D's survive/crash
        # boundary, module docstring) slams the hull down => game over
        hard = (jn1 > J_CRASH) | (jn2 > J_CRASH)

        # --- integrate (semi-implicit Euler, Box2D order) -------------------
        comx = comx + vx * dt
        comy = comy + vy * dt
        angle = state.angle + omega * dt
        sin_n, cos_n = jnp.sin(angle), jnp.cos(angle)
        # body origin = com - R(angle) @ (0, COM_OFFSET)
        x = comx + COM_OFFSET * sin_n
        y = comy - COM_OFFSET * cos_n

        # --- position correction: lift contacting tips back to the surface --
        def tip_at(sign, xx, yy):
            bx, by = sign * LEG_TIP_X, LEG_TIP_Y
            return (
                xx + bx * cos_n - by * sin_n,
                yy + bx * sin_n + by * cos_n,
            )

        q1x, q1y = tip_at(-1.0, x, y)
        q2x, q2y = tip_at(1.0, x, y)
        h1 = _terrain_height(state.terrain, q1x)
        h2 = _terrain_height(state.terrain, q2x)
        pen1 = jnp.where(c1, (h1 + CONTACT_SKIN) - q1y, 0.0)
        pen2 = jnp.where(c2, (h2 + CONTACT_SKIN) - q2y, 0.0)
        lift = jnp.maximum(jnp.maximum(pen1, pen2), 0.0)
        y = y + lift
        comy = comy + lift

        # hull bottom corners touching ground => Box2D BeginContact game_over
        def corner(bx, by):
            return (
                x + bx * cos_n - by * sin_n,
                y + bx * sin_n + by * cos_n,
            )

        hx1, hy1 = corner(HULL_BOTTOM[0], HULL_BOTTOM[2])
        hx2, hy2 = corner(HULL_BOTTOM[1], HULL_BOTTOM[2])
        hull_hit = (hy1 <= _terrain_height(state.terrain, hx1) + 0.01) | (
            hy2 <= _terrain_height(state.terrain, hx2) + 0.01
        )
        game_over = hull_hit | hard

        # --- Box2D sleep => the +100 "rest" trigger -------------------------
        still = (
            c1
            & c2
            & (jnp.abs(vx) < LIN_SLEEP_TOL)
            & (jnp.abs(vy) < LIN_SLEEP_TOL)
            & (jnp.abs(omega) < ANG_SLEEP_TOL)
        )
        sleep = jnp.where(still, state.sleep + 1, 0).astype(jnp.int32)
        rest = sleep >= SLEEP_FRAMES

        new_state = state.replace(
            x=x,
            y=y,
            vx=vx,
            vy=vy,
            angle=angle,
            omega=omega,
            leg1=c1,
            leg2=c2,
            sleep=sleep,
            wind_idx=wind_idx,
            torque_idx=torque_idx,
            t=state.t + 1,
        )
        return new_state, game_over, rest

    # ----------------------------------------------- jointed 3-body physics
    def _physics_step_jointed(self, key, state, action, params, kick_force=None):
        """One Box2D frame with the REAL assembly (lander_solver.py): engine
        impulses on the hull (hull mass/inertia, gym applies them before
        ``world.Step``), then the 3-body sequential-impulse solve with the
        motorized leg joints.  ``game_over`` is the hull touching terrain —
        the actual Box2D crash mechanism — with no calibrated threshold."""
        dt = 1.0 / lander_solver.FPS
        sin_a = jnp.sin(state.angle)
        cos_a = jnp.cos(state.angle)
        tip0, tip1 = sin_a, cos_a
        side0, side1 = -cos_a, sin_a

        comx, comy = lander_solver.hull_com(state.x, state.y, state.angle)
        vx, vy, omega = state.vx, state.vy, state.omega
        IMH, IIH = lander_solver.IMH, lander_solver.IIH

        disp = (
            jax.random.uniform(key, (2,), minval=-1.0, maxval=1.0)
            / SCALE
            * params.dispersion_scale
        )

        # wind/turbulence are FORCES on the hull (ApplyForceToCenter/Torque)
        fx = jnp.zeros_like(vx)
        fy = jnp.zeros_like(vx)
        torque = jnp.zeros_like(vx)
        wind_idx, torque_idx = state.wind_idx, state.torque_idx
        if params.enable_wind:
            airborne = jnp.logical_not(state.leg1 | state.leg2)
            fx = fx + jnp.where(airborne, _wind_pattern(wind_idx) * params.wind_power, 0.0)
            torque = torque + jnp.where(
                airborne, _wind_pattern(torque_idx) * params.turbulence_power, 0.0
            )
            wind_idx = wind_idx + airborne.astype(jnp.int32)
            torque_idx = torque_idx + airborne.astype(jnp.int32)
        if kick_force is not None:
            fx = fx + kick_force[0]
            fy = fy + kick_force[1]

        # --- main engine impulse (same published geometry as rigid mode) ---
        m_power = jnp.where(action == 2, 1.0, 0.0)
        k_main = MAIN_ENGINE_Y_LOCATION / SCALE + 2.0 * disp[0]
        ox_m = tip0 * k_main + side0 * disp[1]
        oy_m = -tip1 * k_main - side1 * disp[1]
        jmx = -ox_m * MAIN_ENGINE_POWER * m_power
        jmy = -oy_m * MAIN_ENGINE_POWER * m_power
        rmx = (state.x + ox_m) - comx
        rmy = (state.y + oy_m) - comy
        vx = vx + jmx * IMH
        vy = vy + jmy * IMH
        omega = omega + (rmx * jmy - rmy * jmx) * IIH

        # --- side engines ---------------------------------------------------
        s_power = jnp.where((action == 1) | (action == 3), 1.0, 0.0)
        direction = jnp.where(action == 3, 1.0, jnp.where(action == 1, -1.0, 0.0))
        k_side = 3.0 * disp[1] + direction * SIDE_ENGINE_AWAY
        ox_s = tip0 * disp[0] + side0 * k_side
        oy_s = -tip1 * disp[0] - side1 * k_side
        jsx = -ox_s * SIDE_ENGINE_POWER * s_power
        jsy = -oy_s * SIDE_ENGINE_POWER * s_power
        rsx = (state.x + ox_s - tip0 * 17.0 / SCALE) - comx
        rsy = (state.y + oy_s + tip1 * SIDE_ENGINE_HEIGHT) - comy
        vx = vx + jsx * IMH
        vy = vy + jsy * IMH
        omega = omega + (rsx * jsy - rsy * jsx) * IIH

        hull = Body(cx=comx, cy=comy, a=state.angle, vx=vx, vy=vy, w=omega)
        hull, l1, l2, touch1, touch2, hull_hit, still, new_acc = (
            lander_solver.assembly_step(
                hull,
                state.leg1_body,
                state.leg2_body,
                state.terrain,
                fx,
                fy,
                torque,
                params.gravity,
                acc=state.solver_acc,
                dt=dt,
                vel_iters=params.vel_iters,
                pos_iters=params.pos_iters,
                vel_tol=params.vel_tol,
            )
        )
        x, y = lander_solver.hull_origin(hull.cx, hull.cy, hull.a)

        sleep = jnp.where(still, state.sleep + 1, 0).astype(jnp.int32)
        rest = sleep >= lander_solver.SLEEP_FRAMES

        new_state = state.replace(
            x=x,
            y=y,
            vx=hull.vx,
            vy=hull.vy,
            angle=hull.a,
            omega=hull.w,
            leg1=touch1,
            leg2=touch2,
            leg1_body=l1,
            leg2_body=l2,
            solver_acc=new_acc,
            sleep=sleep,
            wind_idx=wind_idx,
            torque_idx=torque_idx,
            t=state.t + 1,
        )
        return new_state, hull_hit, rest

    # ------------------------------------------------------------------ step
    def step_env(self, key, state: LunarLanderState, action, params: LunarLanderParams):
        phys = self._physics_step_jointed if params.jointed else self._physics_step
        new_state, game_over, rest = phys(key, state, action, params)

        m_power = jnp.where(action == 2, 1.0, 0.0)
        s_power = jnp.where((action == 1) | (action == 3), 1.0, 0.0)

        obs = self.get_obs(new_state, params)
        out_of_bounds = jnp.abs(obs[0]) >= 1.0

        shaping = self._shaping(new_state, params)
        reward = shaping - state.prev_shaping
        new_state = new_state.replace(prev_shaping=shaping)
        reward = reward - m_power * 0.30 - s_power * 0.03
        crash = game_over | out_of_bounds
        reward = jnp.where(crash, -100.0, jnp.where(rest, 100.0, reward))

        terminated = crash | rest
        truncated = jnp.logical_and(
            new_state.t >= params.max_steps_in_episode, jnp.logical_not(terminated)
        )
        return (
            obs,
            new_state,
            reward.astype(jnp.float32),
            terminated,
            truncated,
        )
