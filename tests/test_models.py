"""Dynamics/cost/obs zoo vs independent NumPy f64 oracles.

Oracles are hand-transcribed from the cited reference math (SURVEY §2c) —
they deliberately re-derive each update step-by-step so a transcription
error in the library would not be mirrored here.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mpc_rs_jax.models import costs, dynamics, noise, observation, reference
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.utils import as_vector_fn

DT = 0.1


def test_params_presets():
    p = CartPoleParams.single_wheel()
    assert p.m2 == pytest.approx(4.0)
    assert p.j1 == pytest.approx(0.15 * 0.05 * 0.05)
    q = CartPoleParams.two_wheel()
    assert q.j2 == pytest.approx(0.1168)
    assert q.j1 == pytest.approx(2.23e-4)


def test_double_integrator():
    step = dynamics.make_double_integrator(DT)
    x0, x1 = step(1.0, 2.0, 3.0)
    assert float(x0) == pytest.approx(1.0 + 2.0 * DT)
    assert float(x1) == pytest.approx(2.0 + 3.0 * DT)


def _np_nonlinear_step(p, x, u, dt):
    # examples/mppi4-non-liner.rs:81-94 (explicit)
    d0 = (p.m1 + p.m2 + p.j1 / p.r_w**2) * (p.m2 * p.l**2 + p.j2)
    d = d0 - p.m2**2 * p.l**2 * np.cos(x[2]) ** 2
    term1 = (p.m1 + p.m2 + p.j1 / p.r_w**2) * p.m2 * p.g * p.l * np.sin(x[2])
    term2 = (p.kt * u / p.r_w + p.m2 * p.l * x[3] ** 2 * np.sin(x[2])) * p.m2 * p.l * np.cos(x[2])
    r = np.array(x, dtype=np.float64)
    r[3] += (term1 - term2) / d * dt
    r[2] += x[3] * dt
    term3 = (p.j2 + p.m2 * p.l**2) * (p.kt * u / p.r_w + p.m2 * p.l * x[3] ** 2 * np.sin(x[2]))
    term4 = p.m2 * p.g * p.l**2 * np.sin(x[2]) * np.cos(x[2])
    r[1] += (term3 + term4) / d * dt
    r[0] += x[1] * dt
    return r


def test_cartpole_nonlinear_vs_oracle():
    p = CartPoleParams.single_wheel()
    step = dynamics.make_cartpole_nonlinear(p, DT)
    x = np.array([0.5, -0.2, 0.3, 1.1])
    u = 7.5
    got = np.array(step(*(jnp.float64(c) for c in x), u))
    want = _np_nonlinear_step(p, x, u, DT)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_cartpole_linear_semi_implicit_order():
    # examples/mppi4.rs:82-89: x2 must use the NEW x3, x1 the NEW x2.
    p = CartPoleParams.single_wheel()
    step = dynamics.make_cartpole_linear(p, DT)
    x = np.array([0.5, 0.0, 0.1, 0.0])
    u = 2.0
    d = p.d_lin
    x3 = x[3] + ((p.m1 + p.m2 + p.j1 / p.r_w**2) / d * p.m2 * p.g * p.l * x[2] - p.m2 * p.l / d / p.r_w * p.kt * u) * DT
    x2 = x[2] + x3 * DT
    x1 = x[1] + (-p.m2**2 * p.g * p.l**2 / d * x2 + (p.m2 * p.l**2 + p.j2) / d / p.r_w * p.kt * u) * DT
    x0 = x[0] + x1 * DT
    got = np.array(step(*(jnp.float64(c) for c in x), u))
    np.testing.assert_allclose(got, [x0, x1, x2, x3], rtol=1e-12)


def _np_ddot(p, dx, th, dth, u, f):
    # mppi4-non-liner-ukf.rs:126-139
    d1 = (2 * p.m1 + p.m2 + 2 * p.j1 / p.r_w**2) * (p.m2 * p.l**2 + p.j2)
    d = d1 - (p.m2 * p.l * np.cos(th)) ** 2
    mllj = p.m2 * p.l**2 + p.j2
    ddx = (
        mllj * p.m2 * p.l / d * dth**2 * np.sin(th)
        - (p.m2 * p.l) ** 2 * p.g / d * np.sin(th) * np.cos(th)
        + 2 * mllj / (d * p.r_w) * p.kt * u
        + mllj / d * f * np.cos(dth)
    )
    ddth = (
        -((p.m2 * p.l) ** 2) / d * dth**2 * np.sin(th) * np.cos(th)
        + (p.m2 * p.g * np.sin(th) - 2 * f) * p.l * (2 * p.m1 + p.m2 + 2 * p.j1 / p.r_w**2) / d
        - 2 * p.m2 * p.l / (d * p.r_w) * p.kt * u * np.cos(th)
        - p.m2 * p.l * f * np.cos(dth) ** 2 / d
    )
    return ddx, ddth


def test_flagship6_vs_oracle():
    p = CartPoleParams.two_wheel()
    step = dynamics.make_flagship6(p)
    x = np.array([0.1, 0.2, 0.3, 0.15, -0.4, 0.5])
    u, dt, f = 3.0, 0.07, 2.0
    got = np.array(step(*(jnp.float64(c) for c in x), u, dt, f))
    ddx, ddth = _np_ddot(p, x[1], x[3], x[4], u, f)
    r = x.copy()
    r[5] = ddth
    r[4] += r[5] * dt
    r[3] += r[4] * dt
    r[2] = ddx
    r[1] += r[2] * dt
    r[0] += r[1] * dt
    np.testing.assert_allclose(got, r, rtol=1e-12)


def test_accel6_explicit_vs_oracle():
    # mpc-ukf-s.rs:135-155: fully explicit (reads old state everywhere)
    p = CartPoleParams.two_wheel()
    step = dynamics.make_accel6(p, with_force=True)
    x = np.array([0.1, 0.2, 0.3, 0.15, -0.4, 0.5])
    u, dt, f = 3.0, 0.07, 2.0
    got = np.array(step(*(jnp.float64(c) for c in x), u, dt, f))
    d1 = (2 * p.m1 + p.m2 + 2 * p.j1 / p.r_w**2) * (p.m2 * p.l**2 + p.j2)
    mllj = p.m2 * p.l**2 + p.j2
    c, s = np.cos(x[3]), np.sin(x[3])
    d = d1 - (p.m2 * p.l * c) ** 2
    r = x.copy()
    r[0] += x[1] * dt
    r[1] += x[2] * dt
    r[2] = (
        mllj * p.m2 * p.l / d * x[4] ** 2 * s
        - (p.m2 * p.l) ** 2 * p.g / d * s * c
        + 2 * mllj / (d * p.r_w) * p.kt * u
        + mllj / d * f * c
    )
    r[3] += x[4] * dt
    r[4] += x[5] * dt
    r[5] = (
        -((p.m2 * p.l) ** 2) / d * x[4] ** 2 * s * c
        + (p.m2 * p.g * s - 2 * f) * p.l * (2 * p.m1 + p.m2 + 2 * p.j1 / p.r_w**2) / d
        - 2 * p.m2 * p.l / (d * p.r_w) * p.kt * u * c
        - p.m2 * p.l * f * c * c / d
    )
    np.testing.assert_allclose(got, r, rtol=1e-12)


def test_shaped4_cost():
    # examples/mppi4.rs:20-27
    x = np.array([3.0, -1.0, 0.2, 0.5])
    got = float(costs.shaped4(*x))
    xc = np.clip(x[0], -2, 2)
    want = (
        2 * xc**2
        + 3 * np.clip(x[1] + 2 * xc, -5, 5) ** 2
        + 5 * (x[2] + 0.35 * np.clip(x[0], -0.75, 0.75)) ** 2
        + 1.2 * x[3] ** 2
    )
    assert got == pytest.approx(want)


def test_hx_imu6_vs_oracle():
    p = CartPoleParams.two_wheel()
    hx = observation.make_hx_imu6(p)
    x = np.array([0.0, 0.3, 0.5, 0.2, -0.1, 0.4])
    got = np.array(hx(jnp.asarray(x)))
    ax = p.g * np.sin(x[3]) + x[2] * np.cos(x[3]) + p.l * x[5]
    az = p.g * np.cos(x[3]) - x[2] * np.sin(x[3]) + p.l * x[4] ** 2
    k = 36.0 * 60.0 / (2 * np.pi * p.r_w)
    want = [k * x[1], -k * x[1], np.degrees(x[4]), az / p.g, ax / p.g]
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_gen_q6_vs_oracle():
    dt = 0.013
    got = np.array(noise.gen_q6(jnp.float64(dt)))
    a, b, cc = dt**4 / 8, dt**3 / 6, dt**3 / 3
    d, e = dt**2 / 2, dt
    q1 = np.zeros((6, 6))
    q1[3, 4], q1[3, 5] = a, b
    q1[4, 3], q1[4, 4], q1[4, 5] = a, cc, d
    q1[5, 3], q1[5, 4], q1[5, 5] = b, d, e
    q2 = np.zeros((6, 6))
    q2[1, 3], q2[1, 4] = a, b
    q2[3, 1], q2[3, 3], q2[3, 4] = a, cc, d
    q2[4, 1], q2[4, 3], q2[4, 4] = b, d, e
    q3 = np.zeros((6, 6))
    q3[0, 1], q3[0, 2] = a, b
    q3[1, 0], q3[1, 1], q3[1, 2] = a, cc, d
    q3[2, 0], q3[2, 1], q3[2, 2] = b, d, e
    want = 100 * q1 + 70 * q2 + 20 * q3
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert np.allclose(got, got.T)


def test_gen_r_mask():
    r = noise.gen_r_mask(jnp.asarray([200.0, 200.0, 20.0, 0.5, 0.5]), noise.enable_bits_to_mask(0b01011))
    diag = np.diag(np.array(r))
    np.testing.assert_allclose(diag, [200.0, 200.0, 1e6, 0.5, 1e6])


def test_planning_err_vs_oracle():
    l = 0.2474
    pe = reference.make_planning_err(l)
    x = np.array([3.0, 0.0, -0.7, 0.0])
    got = np.array(pe(jnp.asarray(x)))
    x_g = x[0] + x[2] * l
    x_g_ref = np.clip(0.0 - x_g, -1.5, 1.5)
    x_g_err = x_g_ref - x_g
    x_g_dot = x[1] + x[3] * l
    x_g_dot_ref = np.clip(1.5 * x_g_err, -1.5, 1.5)
    x_g_dot_err = x_g_dot_ref - x_g_dot
    theta_ref = np.clip(0.5 * x_g_dot_err, -0.3, 0.3)
    want = [x_g_err, x_g_dot_err, theta_ref - x[2], -x[3]]
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_next_plan_rollout():
    np_plan = reference.make_next_plan(0.05)
    plans = reference.rollout_plan(np_plan, jnp.asarray([1.0, 0.0, 0.0, 0.0]), 10)
    assert plans.shape == (10, 4)
    # planner drives x toward 0 with rate limit 0.5*dt
    assert float(plans[0, 0]) == pytest.approx(1.0 - 0.5 * 0.05)
    assert float(plans[-1, 0]) < float(plans[0, 0])


def test_as_vector_fn_roundtrip():
    p = CartPoleParams.single_wheel()
    step = dynamics.make_cartpole_nonlinear(p, DT)
    f = as_vector_fn(step, 4)
    x = jnp.asarray([[0.5, 0.0, 0.1, 0.0], [0.1, 0.2, -0.1, 0.3]])
    out = f(x, jnp.asarray([1.0, -1.0]))
    assert out.shape == (2, 4)
    ref0 = np.array(step(*(x[0, i] for i in range(4)), 1.0))
    np.testing.assert_allclose(np.array(out[0]), ref0, rtol=1e-12)
