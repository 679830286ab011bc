"""Constant-transcription oracles with INDEPENDENT literals (VERDICT r2 #3).

Every physical constant, gain, and matrix entry below is re-typed directly
from the cited reference const block as a Python literal (or the same
const-expression the Rust source spells out, e.g. ``M2 = 2.3 - 2.0*M1``).
NOTHING here imports from ``mpc_rs_jax.models.params`` or shares code with
the library's model zoo — a mistyped constant in ``models/params.py`` or a
mis-transcribed term in ``models/dynamics.py`` cannot be mirrored by these
oracles. All oracles are straight-line NumPy f64 transcriptions of the Rust.

Covered: all five parameter sets × every dynamics model, every cost, every
observation model, gen_q/gen_r, and the reference generators.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mpc_rs_jax.models import costs, dynamics, noise, observation, reference
from mpc_rs_jax.models.params import CartPoleParams  # library side ONLY
from mpc_rs_jax.utils import as_vector_fn

# ---------------------------------------------------------------------------
# Literal const blocks, typed from the reference (one dict per const block).
# Keys: m1, rw, m2, l, j1, j2, g, kt — plain floats, no library imports.
# ---------------------------------------------------------------------------

# examples/mppi4.rs:73-81 == mppi4-non-liner.rs:73-80 == op-mpc-x-calc.rs:186-193
#   == ukf-pen2.rs:8-15 == ukf-pen3.rs:8-15 == pid.rs:62-70 (M2 = 2.3-2*M1+2.0)
SW = dict(m1=150e-3, rw=50e-3, m2=2.3 - 2.0 * 150e-3 + 2.0, l=0.2474,
          j1=150e-3 * 50e-3 * 50e-3, j2=0.2, g=9.81, kt=0.15)

# examples/op-mpc-x.rs:26-48 (M2 = 2.3 - 2*M1, J2 = 0.2)
SWL = dict(SW, m2=2.3 - 2.0 * 150e-3, j2=0.2)

# examples/mpc-ukf-x.rs:17-27 (M2 = 2.3 - 2*M1, J2 = 1.2)
SWHJ = dict(SW, m2=2.3 - 2.0 * 150e-3, j2=1.2)

# examples/ukf-pen.rs:6-14 (J2 = 0.1)
SWJ01 = dict(SW, j2=0.1)

# examples/mppi4-non-liner-ukf.rs:105-123 == mpc-ukf-s.rs:113-133
#   == mppi4-ukf-commu.rs:115-135
TW = dict(m1=160e-3, rw=50e-3, m2=2.4, l=0.4, j1=2.23e5 * 1e-9,
          j2=1.168e8 * 1e-9, g=9.81, kt=0.15)

# (library preset constructor, literal block) pairs — the five param sets
PRESETS = [
    ("single_wheel", CartPoleParams.single_wheel, SW),
    ("single_wheel_light", CartPoleParams.single_wheel_light, SWL),
    ("single_wheel_heavy_j", CartPoleParams.single_wheel_heavy_j, SWHJ),
    ("single_wheel_j01", CartPoleParams.single_wheel_j01, SWJ01),
    ("two_wheel", CartPoleParams.two_wheel, TW),
]

PSET = pytest.mark.parametrize("name,preset,c", PRESETS, ids=[p[0] for p in PRESETS])


def _states4(n=8, seed=0):
    r = np.random.default_rng(seed)
    x = np.stack([r.uniform(-2, 2, n), r.uniform(-3, 3, n),
                  r.uniform(-1.2, 1.2, n), r.uniform(-5, 5, n)], axis=1)
    u = r.uniform(-15, 15, n)
    return x, u


def _states6(n=8, seed=1):
    r = np.random.default_rng(seed)
    x = np.stack([r.uniform(-2, 2, n), r.uniform(-3, 3, n), r.uniform(-8, 8, n),
                  r.uniform(-1.2, 1.2, n), r.uniform(-5, 5, n),
                  r.uniform(-20, 20, n)], axis=1)
    u = r.uniform(-10, 10, n)
    return x, u


def _f64(x):
    return tuple(jnp.float64(v) for v in x)


# ---------------------------------------------------------------------------
# Param-set literal check — every field of every preset vs its const block
# ---------------------------------------------------------------------------

@PSET
def test_preset_fields_vs_literals(name, preset, c):
    p = preset()
    assert p.m1 == pytest.approx(c["m1"], rel=0, abs=0)
    assert p.r_w == pytest.approx(c["rw"], rel=0, abs=0)
    assert p.m2 == pytest.approx(c["m2"], rel=0, abs=0)
    assert p.l == pytest.approx(c["l"], rel=0, abs=0)
    assert p.j1 == pytest.approx(c["j1"], rel=0, abs=0)
    assert p.j2 == pytest.approx(c["j2"], rel=0, abs=0)
    assert p.g == pytest.approx(c["g"], rel=0, abs=0)
    assert p.kt == pytest.approx(c["kt"], rel=0, abs=0)


# ---------------------------------------------------------------------------
# Dynamics oracles — one function per reference dynamics, Rust line order
# ---------------------------------------------------------------------------

def ora_linear4(c, x, u, dt):
    # examples/mppi4.rs:82-89 (sequential: each line reads fresh values)
    m1, rw, m2, l, j1, j2, g, kt = (c["m1"], c["rw"], c["m2"], c["l"],
                                    c["j1"], c["j2"], c["g"], c["kt"])
    d = (m1 + m2 + j1 / (rw * rw)) * (m2 * l * l + j2) - m2 * m2 * l * l
    x = np.array(x, dtype=np.float64)
    x[3] += ((m1 + m2 + j1 / (rw * rw)) / d * m2 * g * l * x[2]
             - m2 * l / d / rw * kt * u) * dt
    x[2] += x[3] * dt
    x[1] += (-m2 * m2 * g * l * l / d * x[2] + (m2 * l * l + j2) / d / rw * kt * u) * dt
    x[0] += x[1] * dt
    return x


def ora_pid_linear4(c, x, u, dt):
    # examples/pid.rs:70-78 — precedence quirk: J1 / R_W * R_W == J1
    m1, rw, m2, l, j1, j2, g, kt = (c["m1"], c["rw"], c["m2"], c["l"],
                                    c["j1"], c["j2"], c["g"], c["kt"])
    d = (m1 + m2 + j1 / rw * rw) * (m2 * l * l + j2) - m2 * m2 * l * l
    x = np.array(x, dtype=np.float64)
    x[3] += ((m1 + m2 + j1 / rw * rw) / d * m2 * g * l * x[2]
             - m2 * l / d / rw * kt * u) * dt
    x[2] += x[3] * dt
    x[1] += (-m2 * m2 * g * l * l / d * x[2] + (m2 * l * l + j2) / d / rw * kt * u) * dt
    x[0] += x[1] * dt
    return x


def ora_nonlinear4(c, x, u, dt):
    # examples/mppi4-non-liner.rs:81-94 (explicit: reads the OLD state)
    m1, rw, m2, l, j1, j2, g, kt = (c["m1"], c["rw"], c["m2"], c["l"],
                                    c["j1"], c["j2"], c["g"], c["kt"])
    r = np.array(x, dtype=np.float64)
    big_d = (m1 + m2 + j1 / (rw * rw)) * (m2 * l * l + j2)
    d = big_d - m2 * m2 * l * l * np.cos(x[2]) * np.cos(x[2])
    term1 = (m1 + m2 + j1 / (rw * rw)) * m2 * g * l * np.sin(x[2])
    term2 = (kt * u / rw + m2 * l * x[3] ** 2 * np.sin(x[2])) * m2 * l * np.cos(x[2])
    r[3] += (term1 - term2) / d * dt
    r[2] += x[3] * dt
    term3 = (j2 + m2 * l * l) * (kt * u / rw + m2 * l * x[3] ** 2 * np.sin(x[2]))
    term4 = m2 * g * l * l * np.sin(x[2]) * np.cos(x[2])
    r[1] += (term3 + term4) / d * dt
    r[0] += x[1] * dt
    return r


def ora_ddot(c, x4, u, f):
    # mppi4-non-liner-ukf.rs:126-139; x4 = [x, dx, theta, dtheta]
    m1, rw, m2, l, j1, j2, g, kt = (c["m1"], c["rw"], c["m2"], c["l"],
                                    c["j1"], c["j2"], c["g"], c["kt"])
    d1 = (2.0 * m1 + m2 + 2.0 * j1 / (rw * rw)) * (m2 * l * l + j2)
    d = d1 - (m2 * l * np.cos(x4[2])) ** 2
    t1 = (m2 * l * l + j2) * m2 * l / d * x4[3] ** 2 * np.sin(x4[2])
    t2 = -((m2 * l) ** 2) * g / d * np.sin(x4[2]) * np.cos(x4[2])
    t3 = 2.0 * (m2 * l * l + j2) / (d * rw) * kt * u
    t4 = (m2 * l * l + j2) / d * f * np.cos(x4[3])
    ddot_x = t1 + t2 + t3 + t4
    t1 = -((m2 * l) ** 2) / d * x4[3] ** 2 * np.sin(x4[2]) * np.cos(x4[2])
    t2 = (m2 * g * np.sin(x4[2]) - 2.0 * f) * l * (2.0 * m1 + m2 + 2.0 * j1 / (rw * rw)) / d
    t3 = -2.0 * m2 * l / (d * rw) * kt * u * np.cos(x4[2])
    t4 = -m2 * l * f * np.cos(x4[3]) ** 2 / d
    return ddot_x, t1 + t2 + t3 + t4


def ora_flagship4(c, x, u, dt):
    # mppi4-non-liner-ukf.rs:141-148 (semi-implicit via fresh r[3]/r[1])
    ddx, ddth = ora_ddot(c, x, u, 0.0)
    r = np.array(x, dtype=np.float64)
    r[3] += ddth * dt
    r[2] += r[3] * dt
    r[1] += ddx * dt
    r[0] += r[1] * dt
    return r


def ora_flagship6(c, x, u, dt, f):
    # mppi4-non-liner-ukf.rs:150-159 (ddot on [x0, x1, x3, x4])
    ddx, ddth = ora_ddot(c, np.array([x[0], x[1], x[3], x[4]]), u, f)
    r = np.array(x, dtype=np.float64)
    r[5] = ddth
    r[4] += r[5] * dt
    r[3] += r[4] * dt
    r[2] = ddx
    r[1] += r[2] * dt
    r[0] += r[1] * dt
    return r


def ora_accel6_force(c, x, u, dt, f):
    # mpc-ukf-s.rs:135-155 (explicit; denominator cos(x[3]) = cos theta)
    m1, rw, m2, l, j1, j2, g, kt = (c["m1"], c["rw"], c["m2"], c["l"],
                                    c["j1"], c["j2"], c["g"], c["kt"])
    d1 = (2.0 * m1 + m2 + 2.0 * j1 / (rw * rw)) * (m2 * l * l + j2)
    r = np.array(x, dtype=np.float64)
    d = d1 - (m2 * l * np.cos(x[3])) ** 2
    r[0] += x[1] * dt
    r[1] += x[2] * dt
    t1 = (m2 * l * l + j2) * m2 * l / d * x[4] ** 2 * np.sin(x[3])
    t2 = -((m2 * l) ** 2) * g / d * np.sin(x[3]) * np.cos(x[3])
    t3 = 2.0 * (m2 * l * l + j2) / (d * rw) * kt * u
    t4 = (m2 * l * l + j2) / d * f * np.cos(x[3])
    r[2] = t1 + t2 + t3 + t4
    r[3] += x[4] * dt
    r[4] += x[5] * dt
    t1 = -((m2 * l) ** 2) / d * x[4] ** 2 * np.sin(x[3]) * np.cos(x[3])
    t2 = (m2 * g * np.sin(x[3]) - 2.0 * f) * l * (2.0 * m1 + m2 + 2.0 * j1 / (rw * rw)) / d
    t3 = -2.0 * m2 * l / (d * rw) * kt * u * np.cos(x[3])
    t4 = -m2 * l * f * np.cos(x[3]) ** 2 / d
    r[5] = t1 + t2 + t3 + t4
    return r


def ora_accel6_commu(c, x, u, dt, quirk=True):
    # mppi4-ukf-commu.rs:137-153 — QUIRK: denominator uses cos(x[2]) (the
    # acceleration slot), a leftover from the 4-state copy; no force terms.
    # quirk=False gives mpc-ukf-commu.rs:151-166 (cos(x[3]), still no force).
    m1, rw, m2, l, j1, j2, g, kt = (c["m1"], c["rw"], c["m2"], c["l"],
                                    c["j1"], c["j2"], c["g"], c["kt"])
    d1 = (2.0 * m1 + m2 + 2.0 * j1 / (rw * rw)) * (m2 * l * l + j2)
    r = np.array(x, dtype=np.float64)
    d = d1 - (m2 * l * np.cos(x[2] if quirk else x[3])) ** 2
    r[0] += x[1] * dt
    r[1] += x[2] * dt
    t1 = (m2 * l * l + j2) * m2 * l / d * x[4] ** 2 * np.sin(x[3])
    t2 = -((m2 * l) ** 2) * g / d * np.sin(x[3]) * np.cos(x[3])
    t3 = 2.0 * (m2 * l * l + j2) / (d * rw) * kt * u
    r[2] = t1 + t2 + t3
    r[3] += x[4] * dt
    r[4] += x[5] * dt
    t1 = -((m2 * l) ** 2) / d * x[4] ** 2 * np.sin(x[3]) * np.cos(x[3])
    t2 = m2 * g * l * (2.0 * m1 + m2 + 2.0 * j1 / (rw * rw)) / d * np.sin(x[3])
    t3 = -2.0 * m2 * l / (d * rw) * kt * u * np.cos(x[3])
    r[5] = t1 + t2 + t3
    return r


def ora_commu4(c, x, u, dt):
    # mppi4-ukf-commu.rs:154-169 (4-state; x[2] IS theta here, no quirk)
    m1, rw, m2, l, j1, j2, g, kt = (c["m1"], c["rw"], c["m2"], c["l"],
                                    c["j1"], c["j2"], c["g"], c["kt"])
    d1 = (2.0 * m1 + m2 + 2.0 * j1 / (rw * rw)) * (m2 * l * l + j2)
    r = np.array(x, dtype=np.float64)
    d = d1 - (m2 * l * np.cos(x[2])) ** 2
    r[0] += x[1] * dt
    t1 = (m2 * l * l + j2) * m2 * l / d * x[3] ** 2 * np.sin(x[2])
    t2 = -((m2 * l) ** 2) * g / d * np.sin(x[2]) * np.cos(x[2])
    t3 = 2.0 * (m2 * l * l + j2) / (d * rw) * kt * u
    r[1] += (t1 + t2 + t3) * dt
    r[2] += x[3] * dt
    t1 = -((m2 * l) ** 2) / d * x[3] ** 2 * np.sin(x[2]) * np.cos(x[2])
    t2 = m2 * g * l * (2.0 * m1 + m2 + 2.0 * j1 / (rw * rw)) / d * np.sin(x[2])
    t3 = -2.0 * m2 * l / (d * rw) * kt * u * np.cos(x[2])
    r[3] += (t1 + t2 + t3) * dt
    return r


def ora_pen6(c, x, u, dt):
    # ukf-pen3.rs:35-51 — QUIRK: denominator uses cos(x[2]) (the ẍ slot)
    m1, rw, m2, l, j1, j2, g, kt = (c["m1"], c["rw"], c["m2"], c["l"],
                                    c["j1"], c["j2"], c["g"], c["kt"])
    big_d = (m1 + m2 + j1 / (rw * rw)) * (m2 * l * l + j2)
    r = np.array(x, dtype=np.float64)
    d = big_d - (m2 * l * np.cos(x[2])) ** 2
    r[0] += x[1] * dt
    r[1] += x[2] * dt
    t3 = (j2 + m2 * l * l) * (kt * u / rw + m2 * l * x[4] ** 2 * np.sin(x[3]))
    t4 = m2 * g * l * l * np.sin(x[3]) * np.cos(x[3])
    r[2] = (t3 + t4) / d
    r[3] += x[4] * dt
    r[4] += x[5] * dt
    t1 = (m1 + m2 + j1 / (rw * rw)) * m2 * g * l * np.sin(x[3])
    t2 = (kt * u / rw + m2 * l * x[4] ** 2 * np.sin(x[3])) * m2 * l * np.cos(x[3])
    r[5] = (t1 - t2) / d
    return r


# ---------------------------------------------------------------------------
# Dynamics tests: library (built from presets) vs oracles (literal blocks),
# at randomized states, for all five param sets where the factory is generic
# ---------------------------------------------------------------------------

def test_double_integrator_vs_literals():
    # examples/mppi2.rs:22-27: next[0] += state[1]*DT; next[1] += u*DT
    dt = 2.0 / 40.0  # T=2.0, N=40 (mppi2.rs:10-11)
    step = dynamics.make_double_integrator(dt)
    xs, us = _states4(seed=10)
    for x, u in zip(xs, us):
        got = np.array(step(jnp.float64(x[0]), jnp.float64(x[1]), u))
        np.testing.assert_allclose(got, [x[0] + x[1] * dt, x[1] + u * dt], rtol=1e-15)


@PSET
def test_linear4_all_presets(name, preset, c):
    for dt in (0.1, 0.05):
        step = dynamics.make_cartpole_linear(preset(), dt)
        xs, us = _states4(seed=11)
        for x, u in zip(xs, us):
            got = np.array(step(*_f64(x), u))
            np.testing.assert_allclose(got, ora_linear4(c, x, u, dt), rtol=1e-12)


@PSET
def test_nonlinear4_all_presets(name, preset, c):
    for dt in (0.1, 0.013):
        step = dynamics.make_cartpole_nonlinear(preset(), dt)
        xs, us = _states4(seed=12)
        for x, u in zip(xs, us):
            got = np.array(step(*_f64(x), u))
            np.testing.assert_allclose(got, ora_nonlinear4(c, x, u, dt), rtol=1e-12)


def test_pid_linear_quirk_vs_literals():
    dt = 1e-3  # pid.rs:12
    step = dynamics.make_cartpole_linear_pid(CartPoleParams.single_wheel(), dt)
    xs, us = _states4(seed=13)
    for x, u in zip(xs, us):
        got = np.array(step(*_f64(x), u))
        np.testing.assert_allclose(got, ora_pid_linear4(SW, x, u, dt), rtol=1e-12)
    # and the quirk is real: with these constants the quirky D differs from
    # the standard D (J1/R_W*R_W == J1 != J1/R_W**2)
    assert not np.allclose(ora_pid_linear4(SW, xs[0], us[0], dt),
                           ora_linear4(SW, xs[0], us[0], dt))


@PSET
def test_ddot_and_flagship_all_presets(name, preset, c):
    ddot = dynamics.make_ddot(preset())
    step4 = dynamics.make_flagship4(preset(), 0.15)
    step6 = dynamics.make_flagship6(preset())
    xs, us = _states4(seed=14)
    x6s, u6s = _states6(seed=15)
    for x, u in zip(xs, us):
        for f in (0.0, 2.0):
            got = np.array(ddot(jnp.float64(x[1]), jnp.float64(x[2]),
                                jnp.float64(x[3]), u, f))
            want = ora_ddot(c, np.array([x[0], x[1], x[2], x[3]]), u, f)
            np.testing.assert_allclose(got, want, rtol=1e-12)
        got4 = np.array(step4(*_f64(x), u))
        np.testing.assert_allclose(got4, ora_flagship4(c, x, u, 0.15), rtol=1e-12)
    for x, u in zip(x6s, u6s):
        for dt, f in ((0.07, 2.0), (0.01, 0.0)):
            got6 = np.array(step6(*_f64(x), u, dt, f))
            np.testing.assert_allclose(got6, ora_flagship6(c, x, u, dt, f), rtol=1e-12)


@PSET
def test_accel6_all_three_variants_all_presets(name, preset, c):
    sf = dynamics.make_accel6(preset(), with_force=True)  # mpc-ukf-s.rs:135-155
    sc = dynamics.make_accel6(preset(), with_force=False)  # mpc-ukf-commu.rs:151-166
    sq = dynamics.make_accel6(preset(), with_force=False,
                              quirk_denominator=True)  # mppi4-ukf-commu.rs:137-153
    xs, us = _states6(seed=16)
    for x, u in zip(xs, us):
        got = np.array(sf(*_f64(x), u, 0.15, 2.0))
        np.testing.assert_allclose(got, ora_accel6_force(c, x, u, 0.15, 2.0), rtol=1e-12)
        got = np.array(sc(*_f64(x), u, 0.06))
        np.testing.assert_allclose(got, ora_accel6_commu(c, x, u, 0.06, quirk=False),
                                   rtol=1e-12)
        got = np.array(sq(*_f64(x), u, 0.06))
        np.testing.assert_allclose(got, ora_accel6_commu(c, x, u, 0.06, quirk=True),
                                   rtol=1e-12)


@PSET
def test_commu4_all_presets(name, preset, c):
    dt = 1.2 / 20.0  # mppi4-ukf-commu.rs:15-17
    step = dynamics.make_commu4(preset(), dt)
    xs, us = _states4(seed=17)
    for x, u in zip(xs, us):
        got = np.array(step(*_f64(x), u))
        np.testing.assert_allclose(got, ora_commu4(c, x, u, dt), rtol=1e-12)


@PSET
def test_pen6_quirk_all_presets(name, preset, c):
    dt = 0.01  # ukf-pen3.rs:18
    step = dynamics.make_pen6(preset(), dt)
    xs, us = _states6(seed=18)
    for x, u in zip(xs, us):
        got = np.array(step(*_f64(x), u))
        np.testing.assert_allclose(got, ora_pen6(c, x, u, dt), rtol=1e-12)


def test_linear_ab_vs_literal_matrices():
    # op-mpc-x-calc.rs:10-21 (single wheel, T=0.8 N=8) — literal A, B
    m1, rw, m2, l, j1, j2, g, kt = (SW["m1"], SW["rw"], SW["m2"], SW["l"],
                                    SW["j1"], SW["j2"], SW["g"], SW["kt"])
    dt = 0.8 / 8.0
    d = (m1 + m2 + j1 / (rw * rw)) * (m2 * l * l + j2) - m2 * m2 * l * l
    a_lit = [[1.0, dt, 0.0, 0.0],
             [0.0, 1.0, -m2 * m2 * g * l * l / d * dt, 0.0],
             [0.0, 0.0, 1.0, dt],
             [0.0, 0.0, (m1 + m2 + j1 / (rw * rw)) / d * m2 * g * l * dt, 1.0]]
    b_lit = [[0.0], [(m2 * l * l + j2) / d / rw * kt * dt], [0.0],
             [-m2 * l / d / rw * kt * dt]]
    a, b = dynamics.linear_ab(CartPoleParams.single_wheel(), dt)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_lit), rtol=1e-14)
    np.testing.assert_allclose(np.asarray(b), np.asarray(b_lit), rtol=1e-14)

    # mpc-ukf-s.rs:101-111 (two wheel, T=1.2 N=8) — literal A, B
    m1, rw, m2, l, j1, j2 = (TW["m1"], TW["rw"], TW["m2"], TW["l"], TW["j1"], TW["j2"])
    dt = 1.2 / 8.0
    d1 = (2.0 * m1 + m2 + 2.0 * j1 / (rw * rw)) * (m2 * l * l + j2)
    d = d1 - m2 * m2 * l * l
    a_lit = [[1.0, dt, 0.0, 0.0],
             [0.0, 1.0, -m2 * m2 * g * l * l / d * dt, 0.0],
             [0.0, 0.0, 1.0, dt],
             [0.0, 0.0, (2.0 * m1 + m2 + 2.0 * j1 / (rw * rw)) * m2 * g * l / d * dt, 1.0]]
    b_lit = [[0.0], [2.0 * (m2 * l * l + j2) / (d * rw) * kt * dt], [0.0],
             [-2.0 * m2 * l / (d * rw) * kt * dt]]
    a, b = dynamics.linear_ab(CartPoleParams.two_wheel(), dt, two_wheel=True)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_lit), rtol=1e-14)
    np.testing.assert_allclose(np.asarray(b), np.asarray(b_lit), rtol=1e-14)


# ---------------------------------------------------------------------------
# Costs
# ---------------------------------------------------------------------------

def test_costs_vs_literals():
    xs, us = _states4(seed=20)
    for x in xs:
        # mppi2.rs:53: x0² + x1²
        assert float(costs.quad2(x[0], x[1])) == pytest.approx(x[0] ** 2 + x[1] ** 2)
        # mppi4.rs:20-27
        xc = min(max(x[0], -2.0), 2.0)
        want = (2.0 * xc ** 2
                + 3.0 * min(max(x[1] + 2.0 * xc, -5.0), 5.0) ** 2
                + 5.0 * (x[2] + 0.35 * min(max(x[0], -0.75), 0.75)) ** 2
                + 1.2 * x[3] ** 2)
        assert float(costs.shaped4(*x)) == pytest.approx(want, rel=1e-12)
        # mppi4-non-liner-ukf.rs:21,33-35: C = [0.1, 0.1, 1.0, 0.5]
        diag = costs.make_diag4(0.1, 0.1, 1.0, 0.5)
        want = 0.1 * x[0] ** 2 + 0.1 * x[1] ** 2 + 1.0 * x[2] ** 2 + 0.5 * x[3] ** 2
        assert float(diag(*x)) == pytest.approx(want, rel=1e-12)
        # mppi4-ukf-commu.rs:171-177: 0 + 1.2 + 3θ² + 3θ̇²
        want = 0.0 + 1.2 + 3.0 * x[2] ** 2 + 3.0 * x[3] ** 2
        assert float(costs.commu4(*x)) == pytest.approx(want, rel=1e-12)


def test_tracking_rollout_cost_vs_literal_loop():
    # op-mpc-x.rs:106-125 with GAIN = [0.0, 9.2, 16.0, 0.5, 0.0] (:80),
    # dynamics = the sequential linear model (:64-69, SWL consts, DT=0.01),
    # planning_err (:86-102), barrier (cosh θ − 1.2)⁺ at weight 1 (:123)
    dt = 0.5 / 50.0
    gain = (0.0, 9.2, 16.0, 0.5, 0.0)
    step = as_vector_fn(dynamics.make_cartpole_linear(
        CartPoleParams.single_wheel_light(), dt), 4)
    perr = reference.make_planning_err(0.2474)
    cost = costs.make_tracking_rollout_cost(step, perr, gain, barrier=1.0)

    def ora_planning_err(x):
        l = 0.2474  # op-mpc-x.rs:33
        x_g = x[0] + x[2] * l
        x_g_ref = min(max(0.0 - x_g, -1.5), 1.5)
        x_g_err = x_g_ref - x_g
        x_g_dot = x[1] + x[3] * l
        x_g_dot_ref = min(max(1.5 * x_g_err, -1.5), 1.5)
        x_g_dot_err = x_g_dot_ref - x_g_dot
        theta_ref = min(max(0.5 * x_g_dot_err, -0.3), 0.3)
        return [x_g_err, x_g_dot_err, theta_ref - x[2], 0.0 - x[3]]

    rng = np.random.default_rng(21)
    x0 = rng.uniform(-1, 1, 4)
    u = rng.uniform(-5, 5, 12)
    c, x = 0.0, x0.copy()
    for e in u:
        x = ora_linear4(SWL, x, e, dt)
        err = ora_planning_err(x)
        c += (0.0 * err[0] ** 2 + 9.2 * err[1] ** 4 + 16.0 * err[2] ** 4
              + 0.5 * err[3] ** 4 + 0.0 * e ** 2)
        c += max(np.cosh(x[2]) - 1.2, 0.0)
    got = float(cost(jnp.asarray(x0), jnp.asarray(u)))
    assert got == pytest.approx(c, rel=1e-9)


# ---------------------------------------------------------------------------
# Observation models
# ---------------------------------------------------------------------------

@PSET
def test_hx_rpm_gyro4_all_presets(name, preset, c):
    # ukf-pen2.rs:47-53 / mppi4-non-liner-s.rs:242-248
    hx = observation.make_hx_rpm_gyro4(preset())
    xs, _ = _states4(seed=22)
    for x in xs:
        got = np.array(hx(jnp.asarray(x)))
        rpm = 60.0 / (2.0 * np.pi * c["rw"]) * x[1]
        np.testing.assert_allclose(got, [rpm, rpm, np.degrees(x[3])], rtol=1e-12)


def test_hx_vel2():
    # ukf-pen.rs:86-91 / mpc-ukf-x.rs:105-110: [dx, dtheta]
    hx = observation.make_hx_vel2()
    xs, _ = _states4(seed=23)
    for x in xs:
        np.testing.assert_allclose(np.array(hx(jnp.asarray(x))), [x[1], x[3]], rtol=1e-12)


@PSET
def test_hx_imu6_all_presets(name, preset, c):
    # mppi4-non-liner-ukf.rs:169-179: gear 36, second encoder negated
    hx = observation.make_hx_imu6(preset())
    xs, _ = _states6(seed=24)
    for x in xs:
        got = np.array(hx(jnp.asarray(x)))
        ax = c["g"] * np.sin(x[3]) + x[2] * np.cos(x[3]) + c["l"] * x[5]
        az = c["g"] * np.cos(x[3]) - x[2] * np.sin(x[3]) + c["l"] * x[4] ** 2
        k = 36.0 * 60.0 / (2.0 * np.pi * c["rw"])
        want = [k * x[1], -k * x[1], np.degrees(x[4]), az / c["g"], ax / c["g"]]
        np.testing.assert_allclose(got, want, rtol=1e-12)


@PSET
def test_hx_force6_all_presets(name, preset, c):
    # ukf-pen3.rs:53-63: force-based IMU, ungeared, both encoders positive
    hx = observation.make_hx_force6(preset())
    xs, _ = _states6(seed=25)
    for x in xs:
        got = np.array(hx(jnp.asarray(x)))
        v = (c["m2"] * c["g"] * np.cos(x[3]) + c["m2"] * x[2] * np.sin(x[3])
             - c["m2"] * c["l"] * x[4] ** 2)
        h = (-c["m2"] * c["g"] * np.sin(x[3]) + c["m2"] * x[2] * np.cos(x[3])
             + c["m2"] * c["l"] * x[5])
        k = 60.0 / (2.0 * np.pi * c["rw"])
        want = [k * x[1], k * x[1], np.degrees(x[4]), v / c["g"], h / c["g"]]
        np.testing.assert_allclose(got, want, rtol=1e-12)


# ---------------------------------------------------------------------------
# Noise builders
# ---------------------------------------------------------------------------

def ora_gen_q6(dt, phy):
    # mppi4-non-liner-ukf.rs:192-221 — matrices typed row-by-row
    dt2 = dt ** 2
    dt3 = dt2 * dt
    dt4 = dt2 ** 2
    q1 = np.array([
        [0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, dt4 / 8.0, dt3 / 6.0],
        [0, 0, 0, dt4 / 8.0, dt3 / 3.0, dt2 / 2.0],
        [0, 0, 0, dt3 / 6.0, dt2 / 2.0, dt],
    ])
    q2 = np.array([
        [0, 0, 0, 0, 0, 0],
        [0, 0, 0, dt4 / 8.0, dt3 / 6.0, 0],
        [0, 0, 0, 0, 0, 0],
        [0, dt4 / 8.0, 0, dt3 / 3.0, dt2 / 2.0, 0],
        [0, dt3 / 6.0, 0, dt2 / 2.0, dt, 0],
        [0, 0, 0, 0, 0, 0],
    ])
    q3 = np.array([
        [0, dt4 / 8.0, dt3 / 6.0, 0, 0, 0],
        [dt4 / 8.0, dt3 / 3.0, dt2 / 2.0, 0, 0, 0],
        [dt3 / 6.0, dt2 / 2.0, dt, 0, 0, 0],
        [0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0],
    ])
    return phy[0] * q1 + phy[1] * q2 + phy[2] * q3


def test_gen_q6_vs_literal_matrices():
    for dt in (0.15, 0.013, 0.06):
        # flagship PHY (mppi4-non-liner-ukf.rs:28) and commu PHY (:28)
        for phy in ((100.0, 70.0, 20.0), (50.0, 50.0, 10.0)):
            got = np.array(noise.gen_q6(jnp.float64(dt), phy=phy))
            np.testing.assert_allclose(got, ora_gen_q6(dt, phy), rtol=1e-12)


def test_gen_r_all_masks_vs_literal_loop():
    # mppi4-ukf-commu.rs:228-236: every dropped channel → 1e6, over all 32
    # bitmask values; both reference R vectors (:29 and mpc-ukf-s.rs:30)
    for r_lit in ([200.0, 200.0, 20.0, 0.5, 0.5], [200.0, 200.0, 10.0, 0.05, 0.05]):
        for enable in range(32):
            want = np.array(r_lit)
            for i in range(5):
                if (enable & (1 << i)) == 0:
                    want[i] = 1e6
            got = np.array(noise.gen_r_mask(jnp.asarray(r_lit),
                                            noise.enable_bits_to_mask(enable)))
            np.testing.assert_allclose(np.diag(got), want, rtol=1e-12)
            np.testing.assert_allclose(got, np.diag(want), rtol=1e-12)


# ---------------------------------------------------------------------------
# Reference generators
# ---------------------------------------------------------------------------

def test_gen_ref_raised_cosine_vs_literal_loop():
    # op-mpc-x-calc.rs:29-39 (4×N column layout → our N×4)
    n = 8
    gen = reference.make_gen_ref_raised_cosine(n)
    for x0 in (-1.7, 0.5, 3.0):
        got = np.array(gen(jnp.asarray([x0, 0.0, 0.0, 0.0])))
        want = np.zeros((n, 4))
        for i in range(n):
            phase = np.pi * i / n
            want[i, 0] = (x0 * (1.0 + np.cos(phase))) / 2.0
            want[i, 1] = min(max(-0.4 * x0, -2.0), 2.0) * np.sin(phase)
            want[i, 2] = min(max(-0.5 * x0, -0.35), 0.35) * (1.0 * np.cos(phase)) / 2.0
            want[i, 3] = min(max(-0.5 * x0, -1.5), 1.5) * np.sin(phase)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_next_plan_and_plan_err_vs_literal_loop():
    # mpc-ukf-x.rs:182-216, DT = 0.5/10 (:29-30), rate limits [0.5,1.2,1.5,5.0]·DT
    dt = 0.5 / 10.0
    np_plan = reference.make_next_plan(dt)
    perr = reference.make_plan_err(0.2474)
    rng = np.random.default_rng(26)
    plan = rng.uniform(-1, 1, 4)
    x = rng.uniform(-1, 1, 4)
    max_dx = [0.5 * dt, 1.2 * dt, 1.5 * dt, 5.0 * dt]
    for _ in range(5):
        want = plan.copy()
        d_x = min(max(0.0 - plan[0], -max_dx[0]), max_dx[0])
        want[0] += d_x
        dd_x = d_x - plan[1]
        want[1] += min(max(dd_x, -max_dx[1]), max_dx[1])
        d_theta = d_x * 0.5 - plan[2]
        want[2] += min(max(d_theta, -max_dx[2]), max_dx[2])
        dd_theta = d_theta * 3.0 - plan[3]
        want[3] += min(max(dd_theta, -max_dx[3]), max_dx[3])
        got = np.array(np_plan(jnp.asarray(plan)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
        plan = want
    l = 0.2474
    e = np.array(perr(jnp.asarray(x), jnp.asarray(plan)))
    want_e = [plan[0] - (x[0] + x[2] * l), plan[1] - (x[1] + x[3] * l),
              plan[2] - x[2], plan[3] - x[3]]
    np.testing.assert_allclose(e, want_e, rtol=1e-6)


def test_gen_ref_zero():
    gen = reference.make_gen_ref_zero(8)  # mpc-ukf-s.rs:179-181
    out = np.array(gen(jnp.asarray([1.0, 2.0, 3.0, 4.0])))
    assert out.shape == (8, 4) and not out.any()


def test_hand_tuned_ukf_qr_literals():
    # mppi4-non-liner-s.rs:216-228: the --ref-qr constants in mppi_examples
    from mpc_rs_jax.apps import mppi_examples as me
    import inspect

    src = inspect.getsource(me)
    # Q rows [0,0,0,0],[0,0,0,1],[0,0,1,1e2],[0,1,1e2,1e4]; R diag [50,50,0.5]
    assert "[[0, 0, 0, 0], [0, 0, 0, 1.0], [0, 0, 1.0, 1e2], [0, 1.0, 1e2, 1e4]]" in src
    assert "50.0" in src and "0.5" in src
