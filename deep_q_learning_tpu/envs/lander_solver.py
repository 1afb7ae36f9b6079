"""Jointed 3-body impulse solver for the LunarLander assembly (pure JAX).

Round-3 fidelity work (VERDICT r2 item 2): the round-2 env modeled the lander
as ONE rigid body with a calibrated crash threshold; touchdown outcomes could
flip vs Box2D and free flight carried the leg-swing momentum in the hull.
This module implements the REAL assembly the reference trains against
(``/root/reference/Test/lunar_lander.py:44`` -> gymnasium Box2D lander):

  * hull (6-vertex polygon, density 5) + two legs (2x8 px boxes, density 1),
  * revolute joints: hull origin <-> leg local (i*20, 18)/SCALE, motorized
    (speed 0.3*i, max torque 40) with angle limits ([0.4, 0.9] mirrored),
  * leg<->terrain contacts with friction mu = sqrt(0.2*0.1), restitution 0.

The algorithm is Box2D 2.3.5's sequential-impulse solver, reproduced
operation-for-operation where it matters for trajectory parity:

  integrate velocities (gravity+forces) -> velocity iterations { per joint:
  motor, then limit+point 3x3 block (or point 2x2 when the limit is
  inactive); per contact manifold: friction then normal (2-point block
  solve) } -> integrate positions (translation/rotation clamps) -> position
  iterations { contacts (Baumgarte 0.2, slop 0.005, max 0.2), then joints
  (point + clamped limit correction) } -> island sleep bookkeeping.

Solver constants below are b2Settings values read from the installed
pybox2d 2.3.5; body constants are b2Body masses/inertias measured by
instantiating the real fixtures (see tests/test_lander_solver.py).

Deliberate approximations (documented; measured in artifacts/
gym_parity.json):
  * contact manifolds are corner-vs-supporting-segment (up to 2 deepest box
    corners per leg, block-solved when they share a segment).  Box2D's
    edge-polygon clipping adds apex contacts when a terrain PEAK pokes into
    a box face between corners — rare (box spans 0.13 of a 2.0 chunk) and
    crash-bound when it happens;
  * warm starting IS implemented (accumulated joint/contact impulses carried
    across frames in ``AssemblyAcc``): it is load-bearing, not an
    optimization.  The revolute point constraint raises the leg's effective
    inertia about the anchor ~33x over its COM inertia, so the motor/limit
    converge at ~1/30 per iteration — Box2D's statics work BECAUSE the
    converged impulses persist across frames.  Measured without warm
    starting: a lander standing on its legs sinks ~0.6 m/s and splays to the
    opposite joint limit (the round-3 debugging trail);
  * hull-ground contact sets ``game_over`` (as in gym, where BeginContact
    ends the episode) but is not impulse-resolved — the episode terminates
    on that frame, so post-crash hull dynamics are never observed.

Everything is scalar-per-env jnp code: ``VectorEnv`` vmaps it over
thousands of landers and the iteration loops are ``lax.fori_loop`` so the
jaxpr stays small (CLAUDE.md: the lander superstep compile is minutes —
loop bodies must be compact).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------- world spec
FPS = 50.0
SCALE = 30.0
W = 600.0 / SCALE
CHUNKS = 11

# ------------------------------------------------- measured body constants
# (pybox2d 2.3.5: b2Body.mass / .inertia (about COM) / .localCenter for the
# published fixtures — LANDER_POLY at density 5, 2x8 px leg boxes at 1.)
HULL_M = 4.816666603088379
# TRAP: pybox2d's body.inertia (b2Body::GetInertia) returns the inertia
# about the body ORIGIN (m_I + m*|localCenter|^2 = 0.8333), but the solver
# uses m_invI = 1/m_I about the COM.  Using the readout verbatim made the
# assembly's side-engine spin response 5% low (round-3 debugging: rigid
# momentum analysis pinned I_eff = 0.9111, which back-solves to exactly
# this COM inertia).
HULL_I = 0.8333148956298828 - HULL_M * 0.10130719095468521**2  # = 0.783881
HULL_CX, HULL_CY = 0.0, 0.10130719095468521  # localCenter (body frame)
LEG_M = 0.07111112028360367
LEG_I = 0.0017909470479935408  # about the leg COM (= leg origin)
LEG_HW = 2.0 / SCALE  # box half extents
LEG_HH = 8.0 / SCALE
LEG_AWAY = 20.0 / SCALE
LEG_DOWN = 18.0 / SCALE
MU = 0.14142136  # sqrt(leg 0.2 x ground 0.1) — b2MixFriction

IMH, IIH = 1.0 / HULL_M, 1.0 / HULL_I
IML, IIL = 1.0 / LEG_M, 1.0 / LEG_I

# joints: leg i=-1 limits [0.4, 0.9] motorSpeed -0.3; i=+1 mirrored
MOTOR_TORQUE = 40.0
MOTOR_MASS = 1.0 / (IIH + IIL)

# ------------------------------------------------------- b2Settings (2.3.5)
TOTAL_RADIUS = 0.02  # b2_polygonRadius (0.01) x2: edge + polygon skins
LINEAR_SLOP = 0.005
ANGULAR_SLOP = 0.03490658503988889
BAUMGARTE = 0.2
MAX_LINEAR_CORRECTION = 0.2
MAX_ANGULAR_CORRECTION = 0.13962634015955555
MAX_TRANSLATION = 2.0
MAX_ROTATION = 1.570796326795
LIN_SLEEP_TOL = 0.01
ANG_SLEEP_TOL = 0.03490658503988889
SLEEP_FRAMES = 25  # b2_timeToSleep 0.5 s at 50 FPS

# gym calls world.Step(1/FPS, 6*30, 2*30); convergence plateaus far earlier
# for this 3-body island, so these are configurable at trace time.
VEL_ITERS = 180
POS_ITERS = 60

# hull polygon vertices (body frame, m) for ground-contact detection
HULL_VERTS = tuple(
    (x / SCALE, y / SCALE)
    for x, y in ((-14, 17), (-17, 0), (-17, -10), (17, -10), (17, 0), (14, 17))
)


class Body(NamedTuple):
    """One rigid body, scalar-per-env: COM world position, angle, COM linear
    velocity, angular velocity."""

    cx: jax.Array
    cy: jax.Array
    a: jax.Array
    vx: jax.Array
    vy: jax.Array
    w: jax.Array


def rot(a, x, y):
    c, s = jnp.cos(a), jnp.sin(a)
    return c * x - s * y, s * x + c * y


def hull_com(x, y, a):
    """Hull COM world position from the body-origin position gym reports."""
    ox, oy = rot(a, HULL_CX, HULL_CY)
    return x + ox, y + oy


def hull_origin(cx, cy, a):
    ox, oy = rot(a, HULL_CX, HULL_CY)
    return cx - ox, cy - oy


# --------------------------------------------------------------- terrain geom
def _onehot_pick(vec, idx):
    """``vec[..., idx]`` as a one-hot contraction over the last axis.

    Replacement for a batched dynamic gather: under vmap a ``vec[i0]`` with
    per-env indices lowers to an XLA gather.  The one-hot form is pure
    compare+multiply+reduce — fully fusable — and bit-identical (the sum
    selects exactly one element; the rest contribute +0.0).  Whether it
    still beats the gather on the GPU is unmeasured (ROADMAP design 3.5)."""
    oh = (idx[..., None] == jnp.arange(vec.shape[-1])).astype(vec.dtype)
    return jnp.sum(oh * vec, axis=-1)


def _segment(terrain, x):
    """Supporting terrain segment under world x: (x1, h1, nx, ny) with the
    unit normal pointing up (edge fixtures run left->right)."""
    chunk_w = W / (CHUNKS - 1)
    i0 = jnp.clip(jnp.floor(x / chunk_w).astype(jnp.int32), 0, CHUNKS - 2)
    h1 = _onehot_pick(terrain, i0)  # broadcasts over any point axes of i0
    h2 = _onehot_pick(terrain, i0 + 1)
    dy = h2 - h1
    inv = 1.0 / jnp.sqrt(chunk_w * chunk_w + dy * dy)
    return i0, i0.astype(jnp.float32) * chunk_w, h1, -dy * inv, chunk_w * inv


def _corner_sep(terrain, px, py):
    """Effective separation (skin-adjusted) of a world point vs its
    supporting segment; returns (seg_idx, sep, x1, h1, nx, ny)."""
    seg, x1, h1, nx, ny = _segment(terrain, px)
    sep = (px - x1) * nx + (py - h1) * ny - TOTAL_RADIUS
    return seg, sep, x1, h1, nx, ny


class AssemblyAcc(NamedTuple):
    """Warm-start accumulators carried across frames (b2's m_impulse /
    m_motorImpulse / contact normal+tangent impulses, plus the persisted
    joint limit state that gates the z-impulse reset)."""

    j1: jax.Array  # (4,) [px, py, z, motor] for the side=-1 joint
    j2: jax.Array  # (4,)
    s1: jax.Array  # () int32 limit state: -1 atLower / 0 inactive / +1 atUpper
    s2: jax.Array
    c1: jax.Array  # (4, 2) per-corner [normal, tangent] impulse, leg 1
    c2: jax.Array  # (4, 2)


def zero_acc() -> AssemblyAcc:
    return AssemblyAcc(
        j1=jnp.zeros((4,), jnp.float32),
        j2=jnp.zeros((4,), jnp.float32),
        s1=jnp.int32(0),
        s2=jnp.int32(0),
        c1=jnp.zeros((4, 2), jnp.float32),
        c2=jnp.zeros((4, 2), jnp.float32),
    )


class LegContacts(NamedTuple):
    """Up to two contact points for one leg (the two deepest box corners).
    All leaves scalar-per-env except where noted."""

    active1: jax.Array  # bool
    active2: jax.Array
    # contact frame (shared segment => same normal; else per-point)
    nx1: jax.Array
    ny1: jax.Array
    nx2: jax.Array
    ny2: jax.Array
    # world corner points
    px1: jax.Array
    py1: jax.Array
    px2: jax.Array
    py2: jax.Array
    # corner locations in the LEG body frame (for position re-projection)
    lx1: jax.Array
    ly1: jax.Array
    lx2: jax.Array
    ly2: jax.Array
    # supporting segment reference (for position re-projection)
    sx1: jax.Array
    sh1: jax.Array
    sx2: jax.Array
    sh2: jax.Array
    block: jax.Array  # bool: both points share a segment -> 2x2 block solve
    idx1: jax.Array  # corner index (0..3): warm-start identity across frames
    idx2: jax.Array


def collide_leg(terrain, leg: Body) -> Tuple[LegContacts, jax.Array]:
    """Manifold for one leg box vs terrain: the two deepest of the four box
    corners.  Returns (contacts, touching) where touching mirrors gym's
    ``leg.ground_contact`` (any manifold point)."""
    cxs = jnp.stack(
        [jnp.full_like(leg.cx, s * LEG_HW) for s in (-1.0, 1.0, -1.0, 1.0)], -1
    )
    cys = jnp.stack(
        [jnp.full_like(leg.cx, s * LEG_HH) for s in (-1.0, -1.0, 1.0, 1.0)], -1
    )
    wx, wy = rot(leg.a[..., None], cxs, cys)
    px = leg.cx[..., None] + wx
    py = leg.cy[..., None] + wy
    seg, sep, x1, h1, nx, ny = _corner_sep(terrain, px, py)

    first = jnp.argmin(sep, axis=-1)
    masked = jnp.where(
        jnp.arange(4) == first[..., None], jnp.inf, sep
    )
    second = jnp.argmin(masked, axis=-1)

    def pick(arr, idx):
        # one-hot contraction over the 4-corner axis (no gather; see
        # _onehot_pick).  idx dtype drives the compare; arr may be bool.
        oh = idx[..., None] == jnp.arange(arr.shape[-1])
        if arr.dtype == jnp.bool_:
            return jnp.any(oh & arr, axis=-1)
        return jnp.sum(oh.astype(arr.dtype) * arr, axis=-1)

    s1, s2 = pick(sep, first), pick(sep, second)
    c = LegContacts(
        active1=s1 <= 0.0,
        active2=s2 <= 0.0,
        nx1=pick(nx, first),
        ny1=pick(ny, first),
        nx2=pick(nx, second),
        ny2=pick(ny, second),
        px1=pick(px, first),
        py1=pick(py, first),
        px2=pick(px, second),
        py2=pick(py, second),
        lx1=pick(cxs, first),
        ly1=pick(cys, first),
        lx2=pick(cxs, second),
        ly2=pick(cys, second),
        sx1=pick(x1, first),
        sh1=pick(h1, first),
        sx2=pick(x1, second),
        sh2=pick(h1, second),
        block=pick(seg, first) == pick(seg, second),
        idx1=first,
        idx2=second,
    )
    return c, c.active1 | c.active2


def hull_touches(terrain, hull: Body) -> jax.Array:
    """Any hull polygon vertex within contact range of the terrain — gym's
    ``game_over`` BeginContact trigger."""
    hit = jnp.zeros_like(hull.cx, dtype=bool)
    for bx, by in HULL_VERTS:
        lx, ly = bx - HULL_CX, by - HULL_CY  # vertex relative to hull COM
        wx, wy = rot(hull.a, lx, ly)
        _, sep, *_ = _corner_sep(terrain, hull.cx + wx, hull.cy + wy)
        hit = hit | (sep <= 0.0)
    return hit


# ----------------------------------------------------------- the full step
def assembly_step(
    hull: Body,
    leg1: Body,
    leg2: Body,
    terrain: jax.Array,
    fx: jax.Array,
    fy: jax.Array,
    torque: jax.Array,
    gravity,
    acc: AssemblyAcc = None,
    dt: float = 1.0 / FPS,
    vel_iters: int = VEL_ITERS,
    pos_iters: int = POS_ITERS,
    vel_tol: float = 0.0,
    return_iters: bool = False,
):
    """One ``world.Step`` for the 3-body island.

    ``fx, fy, torque`` are forces on the HULL for this step (reset kick,
    wind/turbulence — gym's ApplyForceToCenter/ApplyTorque).  Engine
    IMPULSES must already be applied to ``hull``'s velocities by the caller
    (gym applies them before ``world.Step``).  ``acc`` carries the
    warm-start accumulators between frames (``zero_acc()`` for a fresh
    assembly).

    Returns ``(hull', leg1', leg2', touch1, touch2, hull_hit, still, acc')``
    where ``still`` is this frame's island sleep predicate (all bodies below
    the b2 sleep tolerances).
    """
    if acc is None:
        acc = zero_acc()
    # ---- collide (manifolds from start-of-step poses, like b2World::Step)
    c1, touch1 = collide_leg(terrain, leg1)
    c2, touch2 = collide_leg(terrain, leg2)
    hull_hit = hull_touches(terrain, hull)

    # ---- integrate velocities (gravity + external forces on the hull)
    hull = hull._replace(
        vx=hull.vx + dt * fx * IMH,
        vy=hull.vy + dt * (gravity + fy * IMH),
        w=hull.w + dt * torque * IIH,
    )
    leg1 = leg1._replace(vy=leg1.vy + dt * gravity)
    leg2 = leg2._replace(vy=leg2.vy + dt * gravity)

    # ---- joint constant data (arms fixed over the velocity iterations)
    def joint_data(leg: Body, side):
        rax, ray = rot(hull.a, 0.0 - HULL_CX, 0.0 - HULL_CY)  # anchor A = origin
        rbx, rby = rot(leg.a, side * LEG_AWAY, LEG_DOWN)
        k11 = IMH + IML + IIH * ray * ray + IIL * rby * rby
        k12 = -IIH * rax * ray - IIL * rbx * rby
        k13 = -IIH * ray - IIL * rby
        k22 = IMH + IML + IIH * rax * rax + IIL * rbx * rbx
        k23 = IIH * rax + IIL * rbx
        k33 = IIH + IIL
        # pybox2d's revoluteJointDef sets referenceAngle = angleB - angleA at
        # creation (= i*0.05), so the limit engages at rel = limit + i*0.05 —
        # verified empirically on the isolated assembly (settle rel 0.3479
        # for limits [0.4, 0.9], not 0.398).
        angle = leg.a - hull.a - side * 0.05
        lower = jnp.where(side < 0, 0.4, -0.9)
        upper = jnp.where(side < 0, 0.9, -0.4)
        at_lower = angle <= lower
        at_upper = angle >= upper
        st = jnp.where(at_lower, -1, jnp.where(at_upper, 1, 0)).astype(jnp.int32)
        return dict(
            rax=rax, ray=ray, rbx=rbx, rby=rby,
            k11=k11, k12=k12, k13=k13, k22=k22, k23=k23, k33=k33,
            at_lower=at_lower, at_upper=at_upper, st=st,
            motor_speed=0.3 * side, lower=lower, upper=upper, side=side,
        )

    j1 = joint_data(leg1, -1.0)
    j2 = joint_data(leg2, 1.0)

    # ---- contact constant data
    def contact_data(leg: Body, c: LegContacts):
        r1x, r1y = c.px1 - leg.cx, c.py1 - leg.cy
        r2x, r2y = c.px2 - leg.cx, c.py2 - leg.cy
        cn1 = r1x * c.ny1 - r1y * c.nx1  # cross(r, n)
        cn2 = r2x * c.ny2 - r2y * c.nx2
        # tangent = cross(n, 1) = (ny, -nx)
        ct1 = r1x * (-c.nx1) - r1y * c.ny1
        ct2 = r2x * (-c.nx2) - r2y * c.ny2
        nm1 = 1.0 / (IML + IIL * cn1 * cn1)
        nm2 = 1.0 / (IML + IIL * cn2 * cn2)
        tm1 = 1.0 / (IML + IIL * ct1 * ct1)
        tm2 = 1.0 / (IML + IIL * ct2 * ct2)
        k11 = IML + IIL * cn1 * cn1
        k22 = IML + IIL * cn2 * cn2
        k12 = IML + IIL * cn1 * cn2
        # b2: fall back to sequential when the block K is ill-conditioned
        block_ok = c.block & (k11 * k22 - k12 * k12 > 1e-3 * k11 * k22)
        det = jnp.where(block_ok, k11 * k22 - k12 * k12, 1.0)
        return dict(
            r1x=r1x, r1y=r1y, r2x=r2x, r2y=r2y,
            nm1=nm1, nm2=nm2, tm1=tm1, tm2=tm2,
            k11=k11, k22=k22, k12=k12, det=det, block_ok=block_ok,
        )

    d1 = contact_data(leg1, c1)
    d2 = contact_data(leg2, c2)

    # ================= velocity iterations (b2Island order: joints, contacts)
    def solve_joint(hv, lv, j, acc):
        """One revolute-joint velocity iteration (b2RevoluteJoint 2.3.5)."""
        hvx, hvy, hw = hv
        lvx, lvy, lw = lv
        px_a, py_a, z_a, m_a = acc
        # motor (skipped only for equal limits, which never happens here)
        cdot = lw - hw - j["motor_speed"]
        imp = -MOTOR_MASS * cdot
        max_imp = dt * MOTOR_TORQUE
        new_m = jnp.clip(m_a + imp, -max_imp, max_imp)
        imp = new_m - m_a
        m_a = new_m
        hw = hw - IIH * imp
        lw = lw + IIL * imp

        limit_active = j["at_lower"] | j["at_upper"]

        # Cdot of the point constraint (recomputed after the motor update)
        def cdot1():
            cx = lvx - lw * j["rby"] - hvx + hw * j["ray"]
            cy = lvy + lw * j["rbx"] - hvy - hw * j["rax"]
            return cx, cy

        # --- limit+point 3x3 branch -------------------------------------
        cdx, cdy = cdot1()
        cdz = lw - hw
        k11, k12, k13 = j["k11"], j["k12"], j["k13"]
        k22, k23, k33 = j["k22"], j["k23"], j["k33"]
        # Solve33: K @ x = -(cdx, cdy, cdz) via cofactors
        det3 = (
            k11 * (k22 * k33 - k23 * k23)
            - k12 * (k12 * k33 - k23 * k13)
            + k13 * (k12 * k23 - k22 * k13)
        )
        det3 = jnp.where(jnp.abs(det3) > 1e-12, det3, 1.0)
        bx, by, bz = -cdx, -cdy, -cdz
        ix = (
            bx * (k22 * k33 - k23 * k23)
            + by * (k13 * k23 - k12 * k33)
            + bz * (k12 * k23 - k13 * k22)
        ) / det3
        iy = (
            bx * (k23 * k13 - k12 * k33)
            + by * (k11 * k33 - k13 * k13)
            + bz * (k13 * k12 - k11 * k23)
        ) / det3
        iz = (
            bx * (k12 * k23 - k22 * k13)
            + by * (k12 * k13 - k11 * k23)
            + bz * (k11 * k22 - k12 * k12)
        ) / det3
        new_z = z_a + iz
        # clamp cases: atLower requires accumulated z >= 0; atUpper z <= 0
        viol_lower = j["at_lower"] & (new_z < 0.0)
        viol_upper = j["at_upper"] & (new_z > 0.0)
        viol = viol_lower | viol_upper
        # reduced 2x2 solve holding z at -z_a (b2's rhs trick)
        rx = -cdx + z_a * k13
        ry = -cdy + z_a * k23
        det2 = k11 * k22 - k12 * k12
        det2 = jnp.where(jnp.abs(det2) > 1e-12, det2, 1.0)
        red_x = (k22 * rx - k12 * ry) / det2
        red_y = (k11 * ry - k12 * rx) / det2
        ix_l = jnp.where(viol, red_x, ix)
        iy_l = jnp.where(viol, red_y, iy)
        iz_l = jnp.where(viol, -z_a, iz)

        # --- point-only 2x2 branch (limit inactive) ----------------------
        ix_p = (k22 * (-cdx) - k12 * (-cdy)) / det2
        iy_p = (k11 * (-cdy) - k12 * (-cdx)) / det2

        dpx = jnp.where(limit_active, ix_l, ix_p)
        dpy = jnp.where(limit_active, iy_l, iy_p)
        dz = jnp.where(limit_active, iz_l, 0.0)

        px_a = px_a + dpx
        py_a = py_a + dpy
        z_a = z_a + dz
        hvx = hvx - IMH * dpx
        hvy = hvy - IMH * dpy
        hw = hw - IIH * (j["rax"] * dpy - j["ray"] * dpx + dz)
        lvx = lvx + IML * dpx
        lvy = lvy + IML * dpy
        lw = lw + IIL * (j["rbx"] * dpy - j["rby"] * dpx + dz)
        return (hvx, hvy, hw), (lvx, lvy, lw), (px_a, py_a, z_a, m_a)

    def solve_contacts(lv, c: LegContacts, d, acc):
        """One contact-manifold velocity iteration: friction per point, then
        normal (2x2 block when both points share a segment)."""
        lvx, lvy, lw = lv
        n1_a, n2_a, t1_a, t2_a = acc
        f1 = c.active1.astype(jnp.float32)
        f2 = c.active2.astype(jnp.float32)

        # friction point 1 (tangent = (ny, -nx))
        tx1, ty1 = c.ny1, -c.nx1
        vt = (lvx - lw * d["r1y"]) * tx1 + (lvy + lw * d["r1x"]) * ty1
        lam = -d["tm1"] * vt
        max_f = MU * n1_a
        new_t = jnp.clip(t1_a + lam, -max_f, max_f)
        lam = (new_t - t1_a) * f1
        t1_a = t1_a + lam
        lvx = lvx + IML * lam * tx1
        lvy = lvy + IML * lam * ty1
        lw = lw + IIL * (d["r1x"] * lam * ty1 - d["r1y"] * lam * tx1)
        # friction point 2
        tx2, ty2 = c.ny2, -c.nx2
        vt = (lvx - lw * d["r2y"]) * tx2 + (lvy + lw * d["r2x"]) * ty2
        lam = -d["tm2"] * vt
        max_f = MU * n2_a
        new_t = jnp.clip(t2_a + lam, -max_f, max_f)
        lam = (new_t - t2_a) * f2
        t2_a = t2_a + lam
        lvx = lvx + IML * lam * tx2
        lvy = lvy + IML * lam * ty2
        lw = lw + IIL * (d["r2x"] * lam * ty2 - d["r2y"] * lam * tx2)

        # normal: block solve over accumulated impulses when both active
        vn1 = (lvx - lw * d["r1y"]) * c.nx1 + (lvy + lw * d["r1x"]) * c.ny1
        vn2 = (lvx - lw * d["r2y"]) * c.nx2 + (lvy + lw * d["r2x"]) * c.ny2
        both = c.active1 & c.active2 & d["block_ok"]
        # b = vn - K @ a
        b1 = vn1 - (d["k11"] * n1_a + d["k12"] * n2_a)
        b2 = vn2 - (d["k12"] * n1_a + d["k22"] * n2_a)
        # case enumeration exactly as b2ContactSolver: first matching case
        # wins; if none matches (degenerate arithmetic) the accumulated
        # impulses are kept unchanged, like Box2D's loop break.
        x1_b = (-d["k22"] * b1 + d["k12"] * b2) / d["det"]
        x2_b = (d["k12"] * b1 - d["k11"] * b2) / d["det"]
        ok_b = (x1_b >= 0.0) & (x2_b >= 0.0)  # case 1: both pushing
        x1_2 = -b1 * d["nm1"]  # case 2: point 1 only (vn2 must separate)
        ok_2 = (x1_2 >= 0.0) & (d["k12"] * x1_2 + b2 >= 0.0)
        x2_3 = -b2 * d["nm2"]  # case 3: point 2 only
        ok_3 = (x2_3 >= 0.0) & (d["k12"] * x2_3 + b1 >= 0.0)
        ok_4 = (b1 >= 0.0) & (b2 >= 0.0)  # case 4: both separating
        x1_blk = jnp.where(
            ok_b, x1_b,
            jnp.where(ok_2, x1_2, jnp.where(ok_3, 0.0, jnp.where(ok_4, 0.0, n1_a))),
        )
        x2_blk = jnp.where(
            ok_b, x2_b,
            jnp.where(ok_2, 0.0, jnp.where(ok_3, x2_3, jnp.where(ok_4, 0.0, n2_a))),
        )
        # sequential fallback (separate manifolds / ill-conditioned K)
        x1_seq = jnp.maximum(n1_a - vn1 * d["nm1"], 0.0)
        # recompute vn2 after point-1's delta for the sequential path
        d1s = (x1_seq - n1_a) * f1
        vn2_s = vn2 + (
            IML * d1s * (c.nx1 * c.nx2 + c.ny1 * c.ny2)
            + IIL
            * (d["r1x"] * c.ny1 - d["r1y"] * c.nx1)
            * (d["r2x"] * c.ny2 - d["r2y"] * c.nx2)
            * d1s
        )
        x2_seq = jnp.maximum(n2_a - vn2_s * d["nm2"], 0.0)
        x1 = jnp.where(both, x1_blk, x1_seq) * f1
        x2 = jnp.where(both, x2_blk, x2_seq) * f2
        dn1, dn2 = x1 - n1_a, x2 - n2_a
        n1_a, n2_a = x1, x2
        lvx = lvx + IML * (dn1 * c.nx1 + dn2 * c.nx2)
        lvy = lvy + IML * (dn1 * c.ny1 + dn2 * c.ny2)
        lw = lw + IIL * (
            (d["r1x"] * c.ny1 - d["r1y"] * c.nx1) * dn1
            + (d["r2x"] * c.ny2 - d["r2y"] * c.nx2) * dn2
        )
        return (lvx, lvy, lw), (n1_a, n2_a, t1_a, t2_a)

    def vel_body(_, carry):
        hv, l1v, l2v, ja1, ja2, ca1, ca2 = carry
        hv, l1v, ja1 = solve_joint(hv, l1v, j1, ja1)
        hv, l2v, ja2 = solve_joint(hv, l2v, j2, ja2)
        l1v, ca1 = solve_contacts(l1v, c1, d1, ca1)
        l2v, ca2 = solve_contacts(l2v, c2, d2, ca2)
        return hv, l1v, l2v, ja1, ja2, ca1, ca2

    # ---- warm start (b2 InitVelocityConstraints): apply last frame's
    # accumulated impulses, carrying the accumulators into the iterations.
    # This is what makes statics work at finite iteration counts — the
    # steady-state contact/motor impulses BUILD UP across frames.
    def warm_joint_acc(j, stored, prev_st):
        px, py = stored[0], stored[1]
        # b2 resets m_impulse.z when the limit state changed; inactive => 0
        z = jnp.where((j["st"] == prev_st) & (j["st"] != 0), stored[2], 0.0)
        return px, py, z, stored[3]

    ja1_0 = warm_joint_acc(j1, acc.j1, acc.s1)
    ja2_0 = warm_joint_acc(j2, acc.j2, acc.s2)

    def apply_joint_warm(hv, lv, j, accj):
        px, py, z, m = accj
        (hvx, hvy, hw), (lvx, lvy, lw) = hv, lv
        hvx = hvx - IMH * px
        hvy = hvy - IMH * py
        hw = hw - IIH * (j["rax"] * py - j["ray"] * px + m + z)
        lvx = lvx + IML * px
        lvy = lvy + IML * py
        lw = lw + IIL * (j["rbx"] * py - j["rby"] * px + m + z)
        return (hvx, hvy, hw), (lvx, lvy, lw)

    def warm_contact_acc(c: LegContacts, stored):
        # stored[(idx, :)] via one-hot over the 4-corner axis (see
        # _onehot_pick)
        oh1 = (c.idx1[..., None] == jnp.arange(4)).astype(jnp.float32)
        oh2 = (c.idx2[..., None] == jnp.arange(4)).astype(jnp.float32)
        p1 = jnp.sum(oh1[..., :, None] * stored, axis=-2)  # (2,)
        p2 = jnp.sum(oh2[..., :, None] * stored, axis=-2)
        f1 = c.active1.astype(jnp.float32)
        f2 = c.active2.astype(jnp.float32)
        return (
            p1[..., 0] * f1, p2[..., 0] * f2, p1[..., 1] * f1, p2[..., 1] * f2
        )

    ca1_0 = warm_contact_acc(c1, acc.c1)
    ca2_0 = warm_contact_acc(c2, acc.c2)

    def apply_contact_warm(lv, c: LegContacts, d, accc):
        n1a, n2a, t1a, t2a = accc
        lvx, lvy, lw = lv
        p1x = n1a * c.nx1 + t1a * c.ny1
        p1y = n1a * c.ny1 + t1a * (-c.nx1)
        p2x = n2a * c.nx2 + t2a * c.ny2
        p2y = n2a * c.ny2 + t2a * (-c.nx2)
        lvx = lvx + IML * (p1x + p2x)
        lvy = lvy + IML * (p1y + p2y)
        lw = lw + IIL * (
            d["r1x"] * p1y - d["r1y"] * p1x + d["r2x"] * p2y - d["r2y"] * p2x
        )
        return (lvx, lvy, lw)

    hv0 = (hull.vx, hull.vy, hull.w)
    l1v0 = (leg1.vx, leg1.vy, leg1.w)
    l2v0 = (leg2.vx, leg2.vy, leg2.w)
    hv0, l1v0 = apply_joint_warm(hv0, l1v0, j1, ja1_0)
    hv0, l2v0 = apply_joint_warm(hv0, l2v0, j2, ja2_0)
    l1v0 = apply_contact_warm(l1v0, c1, d1, ca1_0)
    l2v0 = apply_contact_warm(l2v0, c2, d2, ca2_0)

    carry = (hv0, l1v0, l2v0, ja1_0, ja2_0, ca1_0, ca2_0)
    if vel_tol and vel_tol > 0.0:
        # Convergence early exit — single-env / research use ONLY, off (0.0)
        # in every preset.  Measured on training batches: the
        # median training lane converges in 3-4 iterations, but ~25% of
        # lanes show a CONSTANT per-iteration accumulator delta (~5e-4) that
        # never decays — the joint motor's correction rate is <~0.1%/iter
        # because b2's motorMass (k33 = IIH+IIL) underestimates the ~33x
        # effective leg inertia about the anchor, and Box2D's own behavior
        # (motor impulse accumulating linearly with iteration count) is what
        # fidelity requires.  Under vmap the while_loop exits on the SLOWEST
        # lane, so at training batch sizes this path was slower than the
        # fixed loop.
        def tol_body(tc):
            st, _, it = tc
            new = vel_body(0, st)
            d = jnp.float32(0.0)
            for n, o in zip(jax.tree.leaves(new[3:]), jax.tree.leaves(st[3:])):
                d = jnp.maximum(d, jnp.abs(n.astype(jnp.float32) - o))
            return new, d, it + 1

        def tol_cond(tc):
            _, d, it = tc
            return (it < vel_iters) & ((it == 0) | (d >= vel_tol))

        (hv, l1v, l2v, ja1, ja2, ca1, ca2), _, used_iters = jax.lax.while_loop(
            tol_cond, tol_body, (carry, jnp.float32(jnp.inf), jnp.int32(0))
        )
    else:
        hv, l1v, l2v, ja1, ja2, ca1, ca2 = jax.lax.fori_loop(
            0, vel_iters, vel_body, carry
        )
        used_iters = jnp.int32(vel_iters)
    hull = hull._replace(vx=hv[0], vy=hv[1], w=hv[2])
    leg1 = leg1._replace(vx=l1v[0], vy=l1v[1], w=l1v[2])
    leg2 = leg2._replace(vx=l2v[0], vy=l2v[1], w=l2v[2])

    # ---- store accumulators for the next frame's warm start
    def pack_contact(c: LegContacts, ca):
        # scatter-free: idx1 != idx2 by construction (first/second deepest
        # corners), so the two one-hot outer products write disjoint rows
        n1a, n2a, t1a, t2a = ca
        p1 = jnp.stack([n1a, t1a], -1) * c.active1.astype(jnp.float32)[..., None]
        p2 = jnp.stack([n2a, t2a], -1) * c.active2.astype(jnp.float32)[..., None]
        oh1 = (c.idx1[..., None] == jnp.arange(4)).astype(jnp.float32)
        oh2 = (c.idx2[..., None] == jnp.arange(4)).astype(jnp.float32)
        return (
            oh1[..., :, None] * p1[..., None, :]
            + oh2[..., :, None] * p2[..., None, :]
        )

    new_acc = AssemblyAcc(
        j1=jnp.stack(list(ja1)),
        j2=jnp.stack(list(ja2)),
        s1=j1["st"],
        s2=j2["st"],
        c1=pack_contact(c1, ca1),
        c2=pack_contact(c2, ca2),
    )

    # ---- integrate positions (with b2 translation/rotation clamps)
    def integrate(b: Body) -> Body:
        t2 = (b.vx * b.vx + b.vy * b.vy) * dt * dt
        ratio = jnp.where(t2 > MAX_TRANSLATION**2, MAX_TRANSLATION / jnp.sqrt(t2), 1.0)
        vx, vy = b.vx * ratio, b.vy * ratio
        r = jnp.abs(b.w * dt)
        wratio = jnp.where(r > MAX_ROTATION, MAX_ROTATION / r, 1.0)
        w = b.w * wratio
        return b._replace(
            cx=b.cx + vx * dt, cy=b.cy + vy * dt, a=b.a + w * dt, vx=vx, vy=vy, w=w
        )

    hull, leg1, leg2 = integrate(hull), integrate(leg1), integrate(leg2)

    # ================= position iterations (contacts then joints, b2Island)
    def pos_contact(lp, c: LegContacts):
        """One manifold's position correction (sequential over its points).
        Returns the pass's minimum pre-correction separation, which b2
        uses for the position loop's early exit."""
        lcx, lcy, la = lp
        min_sep = jnp.zeros_like(lcx)

        def one_point(lcx, lcy, la, min_sep, active, lx, ly, sx, sh, nx, ny):
            wxp, wyp = rot(la, lx, ly)
            px, py = lcx + wxp, lcy + wyp
            sep = (px - sx) * nx + (py - sh) * ny - TOTAL_RADIUS
            min_sep = jnp.minimum(min_sep, jnp.where(active, sep, 0.0))
            C = jnp.clip(
                BAUMGARTE * (sep + LINEAR_SLOP), -MAX_LINEAR_CORRECTION, 0.0
            )
            rx, ry = px - lcx, py - lcy
            cn = rx * ny - ry * nx
            K = IML + IIL * cn * cn
            imp = jnp.where(active, -C / K, 0.0)
            lcx = lcx + IML * imp * nx
            lcy = lcy + IML * imp * ny
            la = la + IIL * cn * imp
            return lcx, lcy, la, min_sep

        lcx, lcy, la, min_sep = one_point(
            lcx, lcy, la, min_sep, c.active1, c.lx1, c.ly1, c.sx1, c.sh1, c.nx1, c.ny1
        )
        lcx, lcy, la, min_sep = one_point(
            lcx, lcy, la, min_sep, c.active2, c.lx2, c.ly2, c.sx2, c.sh2, c.nx2, c.ny2
        )
        return (lcx, lcy, la), min_sep

    def pos_joint(hp, lp, side):
        """One revolute joint position correction (limit then point).
        Returns (hp, lp, position_error, angular_error) — the b2 early-exit
        tolerances are checked on the PRE-correction errors."""
        hcx, hcy, ha = hp
        lcx, lcy, la = lp
        angle = la - ha - side * 0.05  # referenceAngle = i*0.05 (see above)
        lower = jnp.where(side < 0, 0.4, -0.9)
        upper = jnp.where(side < 0, 0.9, -0.4)
        at_lower = angle <= lower
        at_upper = angle >= upper
        C_low = jnp.clip(
            (angle - lower) + ANGULAR_SLOP, -MAX_ANGULAR_CORRECTION, 0.0
        )
        C_up = jnp.clip((angle - upper) - ANGULAR_SLOP, 0.0, MAX_ANGULAR_CORRECTION)
        C = jnp.where(at_lower, C_low, jnp.where(at_upper, C_up, 0.0))
        ang_err = jnp.where(
            at_lower, -(angle - lower), jnp.where(at_upper, angle - upper, 0.0)
        )
        limit_imp = -MOTOR_MASS * C
        ha = ha - IIH * limit_imp
        la = la + IIL * limit_imp
        # point constraint
        rax, ray = rot(ha, -HULL_CX, -HULL_CY)
        rbx, rby = rot(la, side * LEG_AWAY, LEG_DOWN)
        Cx = (lcx + rbx) - (hcx + rax)
        Cy = (lcy + rby) - (hcy + ray)
        k11 = IMH + IML + IIH * ray * ray + IIL * rby * rby
        k12 = -IIH * rax * ray - IIL * rbx * rby
        k22 = IMH + IML + IIH * rax * rax + IIL * rbx * rbx
        det = k11 * k22 - k12 * k12
        det = jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
        ix = -(k22 * Cx - k12 * Cy) / det
        iy = -(k11 * Cy - k12 * Cx) / det
        hcx = hcx - IMH * ix
        hcy = hcy - IMH * iy
        ha = ha - IIH * (rax * iy - ray * ix)
        lcx = lcx + IML * ix
        lcy = lcy + IML * iy
        la = la + IIL * (rbx * iy - rby * ix)
        pos_err = jnp.sqrt(Cx * Cx + Cy * Cy)
        return (hcx, hcy, ha), (lcx, lcy, la), pos_err, ang_err

    # b2Island runs the position passes with an early exit: break once the
    # pass's min contact separation >= -3*slop AND every joint's position
    # error <= slop (angular <= angularSlop).  The loop is therefore
    # PATH-DEPENDENT (Baumgarte 0.2 leaves ~slop-scale residuals when it
    # exits), so trajectory parity requires reproducing the exit, not
    # converging further.  Per-env masking emulates the break under vmap.
    def pos_body(carry):
        hp, l1p, l2p, done, it = carry
        n1p, ms1 = pos_contact(l1p, c1)
        n2p, ms2 = pos_contact(l2p, c2)
        min_sep = jnp.minimum(ms1, ms2)
        nhp, n1p, e1, a1 = pos_joint(hp, n1p, -1.0)
        nhp, n2p, e2, a2 = pos_joint(nhp, n2p, 1.0)
        ok = (
            (min_sep >= -3.0 * LINEAR_SLOP)
            & (jnp.maximum(e1, e2) <= LINEAR_SLOP)
            & (jnp.maximum(a1, a2) <= ANGULAR_SLOP)
        )
        keep = lambda new, old: jax.tree.map(
            lambda n, o: jnp.where(done, o, n), new, old
        )
        return keep(nhp, hp), keep(n1p, l1p), keep(n2p, l2p), done | ok, it + 1

    def pos_cond(carry):
        *_, done, it = carry
        return (it < pos_iters) & jnp.logical_not(jnp.all(done))

    carry = (
        (hull.cx, hull.cy, hull.a),
        (leg1.cx, leg1.cy, leg1.a),
        (leg2.cx, leg2.cy, leg2.a),
        jnp.zeros_like(hull.cx, dtype=bool),
        jnp.int32(0),
    )
    hp, l1p, l2p, _, _ = jax.lax.while_loop(pos_cond, pos_body, carry)
    hull = hull._replace(cx=hp[0], cy=hp[1], a=hp[2])
    leg1 = leg1._replace(cx=l1p[0], cy=l1p[1], a=l1p[2])
    leg2 = leg2._replace(cx=l2p[0], cy=l2p[1], a=l2p[2])

    # ---- island sleep predicate (b2Island::Solve sleep bookkeeping)
    def sleepy(b: Body) -> jax.Array:
        return (
            (b.vx * b.vx + b.vy * b.vy < LIN_SLEEP_TOL**2)
            & (b.w * b.w < ANG_SLEEP_TOL**2)
        )

    still = sleepy(hull) & sleepy(leg1) & sleepy(leg2)
    out = (hull, leg1, leg2, touch1, touch2, hull_hit, still, new_acc)
    if return_iters:
        # diagnostics for the vel_tol fast path: velocity iterations actually
        # run (== vel_iters on the fixed-count path).  Under vmap the
        # while_loop carry is select-masked per lane, so this is the TRUE
        # per-env count; the batch's frame cost is its max.
        return out + (used_iters,)
    return out
