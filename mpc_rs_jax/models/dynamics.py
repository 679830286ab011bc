"""Dynamics zoo — every plant model the reference examples exercise.

All functions are component-wise ("structure-of-arrays", see
mpc_rs_jax.utils.structs): they take the state as unpacked arrays plus the
control and return the next-state components. This lets one definition be
traced under ``vmap`` (rollouts), inside Pallas kernels (one rollout per thread), and
for scalar simulation steps alike.

Integration order is replicated *exactly* from the reference — several
models are semi-implicit (later components read freshly-updated earlier
components), others are fully explicit; the distinction changes
trajectories and matters for parity. Citations per factory below.
"""

from __future__ import annotations

import jax.numpy as jnp

from mpc_rs_jax.models.params import CartPoleParams


def make_double_integrator(dt: float):
    """2-state double integrator — examples/mppi2.rs:22-27.

    x0 += x1*dt (old x1); x1 += u*dt. Explicit in x1 for x0.
    """

    def step(x0, x1, u):
        return x0 + x1 * dt, x1 + u * dt

    return step


def make_cartpole_linear(p: CartPoleParams, dt: float):
    """Linear 4-state wheeled pendulum — examples/mppi4.rs:82-89.

    Sequential (semi-implicit) update: x3 from old x2; x2 from *new* x3;
    x1 from *new* x2; x0 from *new* x1 (Rust mutates in place).
    State: [x, dx, theta, dtheta].
    """
    d = p.d_lin
    a32 = p.mass_line / d * p.m2 * p.g * p.l
    b3 = -p.m2 * p.l / d / p.r_w * p.kt
    a12 = -p.m2 * p.m2 * p.g * p.l * p.l / d
    b1 = (p.m2 * p.l * p.l + p.j2) / d / p.r_w * p.kt

    def step(x0, x1, x2, x3, u):
        x3 = x3 + (a32 * x2 + b3 * u) * dt
        x2 = x2 + x3 * dt
        x1 = x1 + (a12 * x2 + b1 * u) * dt
        x0 = x0 + x1 * dt
        return x0, x1, x2, x3

    return step


def _sincos(fast: bool):
    if fast:
        from mpc_rs_jax.ops.fastmath import fsincos

        return fsincos
    return lambda th: (jnp.sin(th), jnp.cos(th))


def make_cartpole_nonlinear(p: CartPoleParams, dt: float | None = None, *, fast: bool = False):
    """Nonlinear 4-state cart-pole — examples/mppi4-non-liner.rs:81-94.

    Fully explicit: every component reads the *old* state. State-dependent
    denominator d = D0 − M2²L²cos²θ. State: [x, dx, theta, dtheta].
    If ``dt`` is None the returned step takes dt as a trailing argument
    ("dynamics_short" form, examples/mppi4-non-liner-s.rs:195-209).

    ``fast=True`` swaps sin/cos for the polynomial ``ops.fastmath``
    versions (≤3e-6 abs err), which speed up the fused kernel's rollout
    (ops/fastmath.py). Exact mode stays the default so oracle/golden tests
    are unchanged.
    """
    sincos = _sincos(fast)
    d0 = p.d0
    ml = p.m2 * p.l

    def step_dt(x0, x1, x2, x3, u, dt):
        s, c = sincos(x2)
        d = d0 - ml * ml * c * c
        thrust = p.kt * u / p.r_w + ml * x3 * x3 * s
        term1 = p.mass_line * p.m2 * p.g * p.l * s
        term2 = thrust * ml * c
        term3 = (p.j2 + p.m2 * p.l * p.l) * thrust
        term4 = p.m2 * p.g * p.l * p.l * s * c
        n3 = x3 + (term1 - term2) / d * dt
        n1 = x1 + (term3 + term4) / d * dt
        n2 = x2 + x3 * dt
        n0 = x0 + x1 * dt
        return n0, n1, n2, n3

    if dt is None:
        return step_dt
    return lambda x0, x1, x2, x3, u: step_dt(x0, x1, x2, x3, u, dt)


# ---------------------------------------------------------------------------
# Flagship two-wheel formulation (examples/mppi4-non-liner-ukf.rs)
# ---------------------------------------------------------------------------

def make_ddot(p: CartPoleParams, *, fast: bool = False):
    """Second-order core (ddot_x, ddot_theta) — mppi4-non-liner-ukf.rs:126-139.

    Takes the 4-state [x, dx, theta, dtheta] plus control u and disturbance
    force f; two driven wheels (factor 2 on M1/J1/KT terms).
    ``fast``: polynomial sin/cos (see make_cartpole_nonlinear).
    """
    sincos = _sincos(fast)
    d1 = p.d1_two
    ml = p.m2 * p.l
    mll_j2 = p.m2 * p.l * p.l + p.j2

    def ddot_fn(dx, theta, dtheta, u, f):
        # Trace-time specialization on f ≡ 0 (the controller rollout path:
        # make_flagship4 always passes a literal 0.0 — the disturbance only
        # drives the PLANT). XLA cannot fold float 0·x (NaN semantics), so
        # without this every rollout step would evaluate cos(dtheta) plus
        # four dead products.
        f_zero = isinstance(f, (int, float)) and f == 0.0
        s, c = sincos(theta)
        d = d1 - (ml * c) ** 2
        # ddot_x — mppi4-non-liner-ukf.rs:128-133
        term1 = mll_j2 * ml / d * dtheta * dtheta * s
        term2 = -(ml**2) * p.g / d * s * c
        term3 = 2.0 * mll_j2 / (d * p.r_w) * p.kt * u
        ddot_x = term1 + term2 + term3
        if not f_zero:
            ddot_x = ddot_x + mll_j2 / d * f * jnp.cos(dtheta)
        # ddot_theta — mppi4-non-liner-ukf.rs:134-138
        t1 = -(ml**2) / d * dtheta * dtheta * s * c
        fs = p.m2 * p.g * s if f_zero else p.m2 * p.g * s - 2.0 * f
        t2 = fs * p.l * p.mass_line_two / d
        t3 = -2.0 * ml / (d * p.r_w) * p.kt * u * c
        ddot_theta = t1 + t2 + t3
        if not f_zero:
            ddot_theta = ddot_theta - ml * f * jnp.cos(dtheta) ** 2 / d
        return ddot_x, ddot_theta

    return ddot_fn


def make_flagship4(p: CartPoleParams, dt: float, *, fast: bool = False):
    """4-state controller model of the flagship — mppi4-non-liner-ukf.rs:141-148.

    State [x, dx, theta, dtheta]; semi-implicit: theta from new dtheta,
    x from new dx.
    """
    ddot = make_ddot(p, fast=fast)

    def step(x0, x1, x2, x3, u):
        ddx, ddth = ddot(x1, x2, x3, u, 0.0)
        n3 = x3 + ddth * dt
        n2 = x2 + n3 * dt
        n1 = x1 + ddx * dt
        n0 = x0 + n1 * dt
        return n0, n1, n2, n3

    return step


def make_flagship6(p: CartPoleParams):
    """6-state plant/UKF model — mppi4-non-liner-ukf.rs:150-159.

    State [x, dx, ddx, theta, dtheta, ddtheta]; accelerations are states.
    Sequential cascade using *new* values; takes (u, dt, f) at call time.
    """
    ddot = make_ddot(p)

    def step(x0, x1, x2, x3, x4, x5, u, dt, f=0.0):
        ddx, ddth = ddot(x1, x3, x4, u, f)
        n5 = ddth
        n4 = x4 + n5 * dt
        n3 = x3 + n4 * dt
        n2 = ddx
        n1 = x1 + n2 * dt
        n0 = x0 + n1 * dt
        return n0, n1, n2, n3, n4, n5

    return step


# ---------------------------------------------------------------------------
# mpc-ukf-s / mppi4-ukf-commu variant (explicit, ẍ as a state)
# ---------------------------------------------------------------------------

def make_accel6(p: CartPoleParams, with_force: bool = True,
                quirk_denominator: bool = False):
    """6-state explicit model — three reference variants share this shape.

    State [x, dx, ddx, theta, dtheta, ddtheta]; *all* reads from the old
    state (r0 += x1*dt, r1 += x2*dt, r2 = ddx(old), ...).

    - mpc-ukf-s.rs:135-155:       ``with_force=True``  (denominator cos θ)
    - mpc-ukf-commu.rs:151-166:   ``with_force=False`` (denominator cos θ)
    - mppi4-ukf-commu.rs:137-153: ``with_force=False, quirk_denominator=True``

    ``quirk_denominator`` replicates (not "fixes") mppi4-ukf-commu.rs:139,
    which builds the denominator with ``cos(x[2])`` — the *acceleration*
    slot, a leftover from the 4-state copy where x[2] was θ — i.e.
    d = D1 − (M2 L cos ẍ)²; the other two examples use ``cos(x[3])`` (θ).
    """
    d1 = p.d1_two
    ml = p.m2 * p.l
    mll_j2 = p.m2 * p.l * p.l + p.j2

    def step(x0, x1, x2, x3, x4, x5, u, dt, f=0.0):
        c, s = jnp.cos(x3), jnp.sin(x3)
        d_cos = jnp.cos(x2) if quirk_denominator else c
        d = d1 - (ml * d_cos) ** 2
        n0 = x0 + x1 * dt
        n1 = x1 + x2 * dt
        term1 = mll_j2 * ml / d * x4 * x4 * s
        term2 = -(ml**2) * p.g / d * s * c
        term3 = 2.0 * mll_j2 / (d * p.r_w) * p.kt * u
        n2 = term1 + term2 + term3
        if with_force:
            n2 = n2 + mll_j2 / d * f * c
        n3 = x3 + x4 * dt
        n4 = x4 + x5 * dt
        t1 = -(ml**2) / d * x4 * x4 * s * c
        t3 = -2.0 * ml / (d * p.r_w) * p.kt * u * c
        if with_force:
            t2 = (p.m2 * p.g * s - 2.0 * f) * p.l * p.mass_line_two / d
            t4 = -ml * f * c * c / d
            n5 = t1 + t2 + t3 + t4
        else:
            t2 = p.m2 * p.g * p.l * p.mass_line_two / d * s
            n5 = t1 + t2 + t3
        return n0, n1, n2, n3, n4, n5

    return step


def make_commu4(p: CartPoleParams, dt: float):
    """4-state controller model of the HW flagship — mppi4-ukf-commu.rs:154-169.

    State [x, dx, theta, dtheta]; fully explicit (all reads old state).
    """
    d1 = p.d1_two
    ml = p.m2 * p.l
    mll_j2 = p.m2 * p.l * p.l + p.j2

    def step(x0, x1, x2, x3, u):
        c, s = jnp.cos(x2), jnp.sin(x2)
        d = d1 - (ml * c) ** 2
        n0 = x0 + x1 * dt
        term1 = mll_j2 * ml / d * x3 * x3 * s
        term2 = -(ml**2) * p.g / d * s * c
        term3 = 2.0 * mll_j2 / (d * p.r_w) * p.kt * u
        n1 = x1 + (term1 + term2 + term3) * dt
        n2 = x2 + x3 * dt
        t1 = -(ml**2) / d * x3 * x3 * s * c
        t2 = p.m2 * p.g * p.l * p.mass_line_two / d * s
        t3 = -2.0 * ml / (d * p.r_w) * p.kt * u * c
        n3 = x3 + (t1 + t2 + t3) * dt
        return n0, n1, n2, n3

    return step


def make_pen6(p: CartPoleParams, dt: float):
    """6-state single-wheel model — examples/ukf-pen3.rs:34-51.

    State [x, dx, ddx, theta, dtheta, ddtheta]; explicit; single-wheel
    (no factor 2); forces via x[3]=theta, x[4]=dtheta.

    Reference quirk replicated (not "fixed"): ukf-pen3.rs:37 builds the
    denominator with ``cos(x[2])`` — the ẍ slot, a leftover from the
    4-state copy where x[2] was θ — i.e. d = D0 − (M2 L cos ẍ)².
    """
    d0 = p.d0
    ml = p.m2 * p.l

    def step(x0, x1, x2, x3, x4, x5, u):
        c, s = jnp.cos(x3), jnp.sin(x3)
        d = d0 - (ml * jnp.cos(x2)) ** 2  # ukf-pen3.rs:37 quirk: cos(ẍ)
        n0 = x0 + x1 * dt
        n1 = x1 + x2 * dt
        thrust = p.kt * u / p.r_w + ml * x4 * x4 * s
        term3 = (p.j2 + p.m2 * p.l * p.l) * thrust
        term4 = p.m2 * p.g * p.l * p.l * s * c
        n2 = (term3 + term4) / d
        n3 = x3 + x4 * dt
        n4 = x4 + x5 * dt
        term1 = p.mass_line * p.m2 * p.g * p.l * s
        term2 = thrust * ml * c
        n5 = (term1 - term2) / d
        return n0, n1, n2, n3, n4, n5

    return step


def make_cartpole_linear_pid(p: CartPoleParams, dt: float):
    """PID-example variant — examples/pid.rs:62-78.

    Identical to ``make_cartpole_linear`` except the reference's D constant
    uses the precedence quirk ``J1 / R_W * R_W`` (== J1, since * and / are
    left-associative) instead of ``J1 / (R_W * R_W)``. Documented, not
    "fixed": we replicate to match trajectories.
    """
    mass_line = p.m1 + p.m2 + p.j1 / p.r_w * p.r_w  # quirk: == m1+m2+j1
    d = mass_line * (p.m2 * p.l * p.l + p.j2) - p.m2 * p.m2 * p.l * p.l
    a32 = mass_line / d * p.m2 * p.g * p.l
    b3 = -p.m2 * p.l / d / p.r_w * p.kt
    a12 = -p.m2 * p.m2 * p.g * p.l * p.l / d
    b1 = (p.m2 * p.l * p.l + p.j2) / d / p.r_w * p.kt

    def step(x0, x1, x2, x3, u):
        x3 = x3 + (a32 * x2 + b3 * u) * dt
        x2 = x2 + x3 * dt
        x1 = x1 + (a12 * x2 + b1 * u) * dt
        x0 = x0 + x1 * dt
        return x0, x1, x2, x3

    return step


def linear_ab(p: CartPoleParams, dt: float, two_wheel: bool = False):
    """Discrete-time (A, B) of the linearized model as numpy-style tuples.

    Single-wheel: examples/op-mpc-x-calc.rs:10-21.
    Two-wheel:    examples/mpc-ukf-s.rs:101-111.
    Returned as nested Python float lists (compile-time constants).
    """
    if two_wheel:
        d = p.d_lin_two
        a_th = p.mass_line_two * p.m2 * p.g * p.l / d * dt
        b_dx = 2.0 * (p.m2 * p.l * p.l + p.j2) / (d * p.r_w) * p.kt * dt
        b_dth = -2.0 * p.m2 * p.l / (d * p.r_w) * p.kt * dt
    else:
        d = p.d_lin
        a_th = p.mass_line / d * p.m2 * p.g * p.l * dt
        b_dx = (p.m2 * p.l * p.l + p.j2) / d / p.r_w * p.kt * dt
        b_dth = -p.m2 * p.l / d / p.r_w * p.kt * dt
    a = [
        [1.0, dt, 0.0, 0.0],
        [0.0, 1.0, -p.m2 * p.m2 * p.g * p.l * p.l / d * dt, 0.0],
        [0.0, 0.0, 1.0, dt],
        [0.0, 0.0, a_th, 1.0],
    ]
    b = [[0.0], [b_dx], [0.0], [b_dth]]
    return a, b
