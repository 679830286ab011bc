"""Matched-noise cross-validation against the independent native oracle.

``native/oracle.cpp`` is a from-scratch f64 C++ transcription of the
reference's MPPI solve (src/mppi.rs:33-92), UKF predict/update
(src/ukf2.rs:44-137), dynamics, costs, and observation models — different
language, different toolchain, zero shared code or constants with the
library. These tests feed BIT-IDENTICAL noise to the oracle and to the
JAX library (``mppi_solve(noise=...)``) and assert agreement:

- whole-solve / whole-filter-step agreement in f64 (tight, ~1e-9), which
  no per-function transcription test can give;
- full matched-noise closed-loop trajectories (the flagship
  mppi4-non-liner-ukf configuration incl. the 2 N disturbance pulse) —
  the stand-in for BASELINE.md item 2's "trajectories regenerated by
  running the Rust examples", which cannot be built here (no cargo);
- the production f32 path against the same f64 oracle, tolerance-banded.
"""

import ctypes
import os
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpc_rs_jax.controllers.mppi import MppiConfig, mppi_solve
from mpc_rs_jax.estimators.ukf import (UkfState, sigma_points as lib_sigma_points,
    ukf_init, ukf_predict, ukf_update, unscented_transform)
from mpc_rs_jax.models import costs, dynamics, noise as noise_mod, observation
from mpc_rs_jax.models.params import CartPoleParams

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SO = os.path.join(_NATIVE, "liboracle.so")

_D = ctypes.POINTER(ctypes.c_double)


def _dp(a):
    return a.ctypes.data_as(_D)


def load_oracle():
    # make no-ops when the library is newer than oracle.cpp
    subprocess.run(["make", "-C", _NATIVE, "liboracle.so"], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(_SO)
    lib.oracle_dynamics.argtypes = [ctypes.c_int, _D, ctypes.c_double, ctypes.c_double, _D]
    lib.oracle_dynamics_short6.argtypes = [_D, ctypes.c_double, ctypes.c_double, ctypes.c_double, _D]
    lib.oracle_cost.restype = ctypes.c_double
    lib.oracle_cost.argtypes = [ctypes.c_int, _D]
    lib.oracle_hx.argtypes = [ctypes.c_int, _D, _D]
    lib.oracle_gen_q6.argtypes = [ctypes.c_double, _D]
    lib.oracle_mppi_solve.restype = ctypes.c_int
    lib.oracle_mppi_solve.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        _D, _D, _D, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, _D,
    ]
    lib.oracle_ukf_predict.restype = ctypes.c_int
    lib.oracle_ukf_predict.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, _D, _D, _D, _D,
    ]
    lib.oracle_ukf_update.restype = ctypes.c_int
    lib.oracle_ukf_update.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _D, _D, _D, _D, _D,
    ]
    lib.oracle_ukf_predict_sqrt.restype = ctypes.c_int
    lib.oracle_ukf_predict_sqrt.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, _D, _D, _D, _D, _D,
    ]
    lib.oracle_sigma_points.restype = ctypes.c_int
    lib.oracle_sigma_points.argtypes = [ctypes.c_int, _D, _D, _D]
    return lib


@pytest.fixture(scope="module")
def lib():
    return load_oracle()


# ---------------------------------------------------------------------------
# ctypes wrappers
# ---------------------------------------------------------------------------

def ora_dynamics(lib, dyn_id, x, u, dt):
    x = np.ascontiguousarray(x, np.float64)
    out = np.empty(x.shape[0] if dyn_id != 1 else 6, np.float64)
    lib.oracle_dynamics(dyn_id, _dp(x), float(u), float(dt), _dp(out))
    return out


def ora_short6(lib, x, u, dt, f):
    x = np.ascontiguousarray(x, np.float64)
    out = np.empty(6, np.float64)
    lib.oracle_dynamics_short6(_dp(x), float(u), float(dt), float(f), _dp(out))
    return out


def ora_hx(lib, hx_id, x):
    x = np.ascontiguousarray(x, np.float64)
    out = np.empty(3 if hx_id == 0 else 5, np.float64)
    lib.oracle_hx(hx_id, _dp(x), _dp(out))
    return out


def ora_mppi(lib, dyn_id, cost_id, x0, u_n, eps, lam, sigma, limit, dt):
    x0 = np.ascontiguousarray(x0, np.float64)
    u_n = np.ascontiguousarray(u_n, np.float64)
    eps = np.ascontiguousarray(eps, np.float64)
    k, n = eps.shape
    out = np.empty(n, np.float64)
    st = lib.oracle_mppi_solve(dyn_id, cost_id, k, n, _dp(x0), _dp(u_n), _dp(eps),
                               float(lam), float(sigma), float(limit[0]),
                               float(limit[1]), float(dt), _dp(out))
    return out, st


class OraUkf:
    """Stateful wrapper mirroring UnscentedKalmanFilter (src/ukf2.rs)."""

    def __init__(self, lib, x0, p0, q, r, fx_id, hx_id):
        self.lib = lib
        self.n = len(x0)
        self.o = r.shape[0]
        self.fx_id, self.hx_id = fx_id, hx_id
        self.x = np.ascontiguousarray(x0, np.float64).copy()
        self.p = np.ascontiguousarray(p0, np.float64).copy()
        self.q = np.ascontiguousarray(q, np.float64).copy()
        self.r = np.ascontiguousarray(r, np.float64).copy()
        self.sigma_f = np.full(((2 * self.n + 1) * self.n,), np.nan)

    def predict(self, u, dt, f=0.0, deltas=None):
        if deltas is None:
            rc = self.lib.oracle_ukf_predict(self.n, self.fx_id, float(u), float(dt),
                                             float(f), _dp(self.q), _dp(self.x),
                                             _dp(self.p), _dp(self.sigma_f))
        else:
            deltas = np.ascontiguousarray(deltas, np.float64)
            rc = self.lib.oracle_ukf_predict_sqrt(self.n, self.fx_id, float(u),
                                                  float(dt), float(f), _dp(self.q),
                                                  _dp(deltas), _dp(self.x),
                                                  _dp(self.p), _dp(self.sigma_f))
        assert rc == 0

    def update(self, z):
        z = np.ascontiguousarray(z, np.float64)
        rc = self.lib.oracle_ukf_update(self.n, self.o, self.hx_id, _dp(z),
                                        _dp(self.r), _dp(self.sigma_f),
                                        _dp(self.x), _dp(self.p))
        assert rc == 0


# ---------------------------------------------------------------------------
# Library-side f64 builders
# ---------------------------------------------------------------------------

SW = CartPoleParams.single_wheel()
TW = CartPoleParams.two_wheel()


def _f64(*a):
    return tuple(jnp.asarray(v, jnp.float64) for v in a)


def jax_flagship6_fx(dt, f=0.0):
    step = dynamics.make_flagship6(TW)

    def fxd(xv, uu):
        out = step(*(xv[..., j] for j in range(6)), uu, jnp.float64(dt), jnp.float64(f))
        return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

    return fxd


def jax_cartpole4_fx(dt):
    step = dynamics.make_cartpole_nonlinear(SW, None)

    def fxd(xv, uu):
        out = step(*(xv[..., j] for j in range(4)), uu, jnp.float64(dt))
        return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

    return fxd


def lib_deltas(params, x, p):
    """Library-eigh sigma deltas (n, n), row i = L_i — shared as DATA with
    the oracle in matched-sqrt tests (see oracle_ukf_predict_sqrt)."""
    sig = lib_sigma_points(params, jnp.asarray(x), jnp.asarray(p))
    n = params.n
    return np.asarray(sig[1:n + 1]) - np.asarray(x)


def lib_predict_with_deltas(params, est, u, fxd, deltas):
    """ukf_predict with the sigma set assembled from supplied deltas —
    identical math to estimators/ukf.py ukf_predict (same concatenation
    order), with the sqrt factored out as data."""
    x = est.x
    d = jnp.asarray(deltas)
    sig = jnp.concatenate([x[None], x[None] + d, x[None] - d], axis=0)
    sigma_f = fxd(sig, u)
    xn, pn = unscented_transform(params.wm, params.wc, sigma_f, est.q)
    return est._replace(x=xn, p=pn, sigma_f=sigma_f)


# ---------------------------------------------------------------------------
# Point parity: dynamics / cost / hx / gen_q (cross-language transcription)
# ---------------------------------------------------------------------------

def _states(n_s, n=16, seed=3):
    r = np.random.default_rng(seed)
    return r.uniform(-1.0, 1.0, size=(n, n_s)) * np.array([1.0, 2.0, 1.0, 3.0, 4.0, 20.0][:n_s])


def test_dynamics_point_parity(lib):
    dt = 0.1
    step4 = dynamics.make_cartpole_nonlinear(SW, dt)
    for x in _states(4):
        for u in (-15.0, 0.0, 7.5):
            got = np.array([float(v) for v in step4(*_f64(*x), jnp.float64(u))])
            np.testing.assert_allclose(got, ora_dynamics(lib, 0, x, u, dt), rtol=1e-13)
    dtf = 0.15
    stepf = dynamics.make_flagship4(TW, dtf)
    for x in _states(4, seed=4):
        for u in (-8.0, 0.0, 3.0):
            got = np.array([float(v) for v in stepf(*_f64(*x), jnp.float64(u))])
            np.testing.assert_allclose(got, ora_dynamics(lib, 2, x, u, dtf), rtol=1e-13)
    step6 = dynamics.make_flagship6(TW)
    for x in _states(6, seed=5):
        for u, f in ((-8.0, 0.0), (3.0, 2.0), (0.0, -1.0)):
            got = np.array([float(v) for v in
                            step6(*_f64(*x), jnp.float64(u), jnp.float64(0.009), jnp.float64(f))])
            np.testing.assert_allclose(got, ora_short6(lib, x, u, 0.009, f), rtol=1e-13)


def test_cost_hx_genq_point_parity(lib):
    for x in _states(4):
        np.testing.assert_allclose(float(costs.shaped4(*_f64(*x))),
                                   lib.oracle_cost(0, _dp(np.ascontiguousarray(x))), rtol=1e-14)
        np.testing.assert_allclose(float(costs.make_diag4(0.1, 0.1, 1.0, 0.5)(*_f64(*x))),
                                   lib.oracle_cost(1, _dp(np.ascontiguousarray(x))), rtol=1e-14)
    hx4 = observation.make_hx_rpm_gyro4(SW)
    hx6 = observation.make_hx_imu6(TW)
    for x in _states(6, seed=7):
        np.testing.assert_allclose(np.asarray(hx4(jnp.asarray(x[:4], jnp.float64))),
                                   ora_hx(lib, 0, x[:4]), rtol=1e-13)
        np.testing.assert_allclose(np.asarray(hx6(jnp.asarray(x, jnp.float64))),
                                   ora_hx(lib, 1, x), rtol=1e-13)
    for dt in (0.009, 0.06, 0.15):
        q = np.empty(36)
        lib.oracle_gen_q6(dt, _dp(q))
        np.testing.assert_allclose(np.asarray(noise_mod.gen_q6(jnp.float64(dt))),
                                   q.reshape(6, 6), rtol=1e-14)


# ---------------------------------------------------------------------------
# Whole MPPI solve, matched noise
# ---------------------------------------------------------------------------

CFG4 = dict(lam=0.5, sigma=3.0, limit=(-20.0, 20.0), dt=0.1)     # mppi4-non-liner.rs:8-18
CFGF = dict(lam=1.4, sigma=4.0, limit=(-10.0, 10.0), dt=0.15)    # mppi4-non-liner-ukf.rs:13-26


def _mppi_jax(cfg_d, dyn_id, x0, u_n, eps, dtype):
    cfg = MppiConfig(n_horizon=eps.shape[1], n_rollouts=eps.shape[0],
                     lambda_=cfg_d["lam"], std_dev=cfg_d["sigma"], limit=cfg_d["limit"])
    if dyn_id == 0:
        step = dynamics.make_cartpole_nonlinear(SW, cfg_d["dt"])
        cost = costs.shaped4
    else:
        step = dynamics.make_flagship4(TW, cfg_d["dt"])
        cost = costs.make_diag4(0.1, 0.1, 1.0, 0.5)
    x = tuple(jnp.asarray(v, dtype) for v in x0)
    res = mppi_solve(cfg, step, cost, jax.random.PRNGKey(0), x,
                     jnp.asarray(u_n, dtype), noise=jnp.asarray(eps, dtype))
    return np.asarray(res.u_n, np.float64), int(res.status)


@pytest.mark.parametrize("dyn_id,cost_id,cfg_d", [(0, 0, CFG4), (2, 1, CFGF)],
                         ids=["cartpole4", "flagship4"])
def test_mppi_solve_matched_noise(lib, dyn_id, cost_id, cfg_d):
    r = np.random.default_rng(11)
    k, n = 4096, 8
    x0 = np.array([0.5, 0.0, 0.1, 0.0])
    u_n = r.uniform(-1.0, 1.0, n)
    eps = cfg_d["sigma"] * r.standard_normal((k, n))
    ora_u, ora_st = ora_mppi(lib, dyn_id, cost_id, x0, u_n, eps, cfg_d["lam"],
                             cfg_d["sigma"], cfg_d["limit"], cfg_d["dt"])
    # f64 JAX: the same algorithm at the same precision — tight.
    u64, st64 = _mppi_jax(cfg_d, dyn_id, x0, u_n, eps, jnp.float64)
    assert st64 == ora_st == 0
    np.testing.assert_allclose(u64, ora_u, rtol=1e-9, atol=1e-12)
    # f32 production path vs the f64 oracle: banded (measured headroom ~10x).
    u32, st32 = _mppi_jax(cfg_d, dyn_id, x0, u_n, eps.astype(np.float32), jnp.float32)
    assert st32 == 0
    np.testing.assert_allclose(u32, ora_u, atol=5e-3)


def test_mppi2_inline_weighting_equivalence(lib):
    """The library reproduces the inline mppi2 weighting (examples/
    mppi2.rs:59-77 — exp(−c/λ − Σ u/R·v), NO max-shift) via
    control_inv=λ/R; the oracle implements the inline form literally.
    Matched noise ⇒ identical normalized averages (the shift cancels)."""
    lib.oracle_mppi2_solve.restype = ctypes.c_int
    lib.oracle_mppi2_solve.argtypes = [
        ctypes.c_longlong, ctypes.c_int, _D, _D, _D, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double, _D,
    ]
    r = np.random.default_rng(17)
    k, n = 2048, 40
    dt = 2.0 / 40  # T=2, N=40 — mppi2.rs:9-11
    lam, r_div = 2.5, 1.0
    x0 = np.array([1.0, 0.0])
    u_n = 0.3 * r.standard_normal(n)
    eps = r_div * r.standard_normal((k, n))
    out = np.empty(n)
    st = lib.oracle_mppi2_solve(k, n, _dp(x0), _dp(np.ascontiguousarray(u_n)),
                                _dp(np.ascontiguousarray(eps)), lam, r_div,
                                -3.0, 3.0, dt, _dp(out))
    assert st == 0
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=lam, std_dev=r_div,
                     limit=(-3.0, 3.0), control_inv=lam / r_div)
    step = dynamics.make_double_integrator(dt)
    res = mppi_solve(cfg, step, costs.quad2, jax.random.PRNGKey(0),
                     tuple(jnp.float64(v) for v in x0),
                     jnp.asarray(u_n, jnp.float64), noise=jnp.asarray(eps))
    assert int(res.status) == 0
    np.testing.assert_allclose(np.asarray(res.u_n), out, rtol=1e-9, atol=1e-12)


def test_mppi_solve_reference_scale(lib):
    """One matched-noise solve at the flagship's OWN K = 5e5
    (examples/mppi4-non-liner-ukf.rs:17) — the averaging scale the
    reference actually runs, not a test-sized stand-in."""
    r = np.random.default_rng(13)
    k, n = 500_000, 8
    x0 = np.array([0.1, -0.2, 0.12, 0.3])
    u_n = 0.5 * r.standard_normal(n)
    eps = CFGF["sigma"] * r.standard_normal((k, n))
    ora_u, ora_st = ora_mppi(lib, 2, 1, x0, u_n, eps, **CFGF)
    u64, st64 = _mppi_jax(CFGF, 2, x0, u_n, eps, jnp.float64)
    assert st64 == ora_st == 0
    np.testing.assert_allclose(u64, ora_u, rtol=1e-9, atol=1e-12)


def test_mppi_status_no_finite_matches(lib):
    """NaN state ⇒ 'Cannot calculate max' (status 1) + zero fallback, both sides."""
    r = np.random.default_rng(1)
    eps = 3.0 * r.standard_normal((64, 8))
    x0 = np.array([np.nan, 0.0, 0.1, 0.0])
    u_n = np.zeros(8)
    ora_u, ora_st = ora_mppi(lib, 0, 0, x0, u_n, eps, **CFG4)
    u64, st64 = _mppi_jax(CFG4, 0, x0, u_n, eps, jnp.float64)
    assert ora_st == st64 == 1
    np.testing.assert_array_equal(ora_u, 0.0)
    np.testing.assert_array_equal(u64, 0.0)


def test_mppi_warm_started_chain(lib):
    """20 receding-horizon solves, u_n fed back verbatim (examples/mppi4.rs:42),
    plant stepped by the solved u[0] — trajectories must track in f64."""
    r = np.random.default_rng(23)
    k, n = 1024, 8
    dt = CFG4["dt"]
    step = dynamics.make_cartpole_nonlinear(SW, dt)
    x_j = np.array([0.5, 0.0, 0.1, 0.0])
    x_o = x_j.copy()
    u_j = np.zeros(n)
    u_o = np.zeros(n)
    for t in range(20):
        eps = CFG4["sigma"] * r.standard_normal((k, n))
        u_o, st_o = ora_mppi(lib, 0, 0, x_o, u_o, eps, **CFG4)
        u_j, st_j = _mppi_jax(CFG4, 0, x_j, u_j, eps, jnp.float64)
        assert st_o == st_j == 0
        x_o = ora_dynamics(lib, 0, x_o, u_o[0], dt)
        x_j = np.array([float(v) for v in step(*_f64(*x_j), jnp.float64(u_j[0]))])
        # Deviation grows at the loop's Lyapunov rate (measured profile:
        # ~1e-14 at t<10, ~2e-6 at t=19): tight early, bounded throughout.
        tol = 1e-12 if t < 8 else 1e-4
        np.testing.assert_allclose(u_j, u_o, atol=tol)
        np.testing.assert_allclose(x_j, x_o, atol=tol)
    assert abs(x_j[2]) < 0.2  # both controllers actually balanced it


# ---------------------------------------------------------------------------
# Whole UKF chains, matched observations
# ---------------------------------------------------------------------------

def test_ukf_flagship6_chain(lib):
    """40 predict/update steps of UKF2(6,5), matched square root: both
    sides consume the same sigma deltas (the sqrt is cross-validated
    separately — see test_sigma_points_cross_validation — because on
    near-degenerate spectra eigh and Jacobi legitimately pick different
    eigenbases and the comparison would measure basis choice, not math).
    Everything else (weights, UT, cross-cov, gain, update, symmetrization)
    runs independently on each side."""
    r = np.random.default_rng(31)
    dt = 0.009  # the flagship UKF thread's ~9 ms cadence
    r_diag = np.array([200.0, 200.0, 10.0, 0.05, 0.05])  # mppi4-non-liner-ukf.rs:28
    q = np.empty(36)
    lib.oracle_gen_q6(dt, _dp(q))
    q = q.reshape(6, 6)
    params, est = ukf_init(jnp.zeros(6, jnp.float64), 10.0 * jnp.eye(6, dtype=jnp.float64),
                           jnp.asarray(q), jnp.diag(jnp.asarray(r_diag)))
    ora = OraUkf(lib, np.zeros(6), 10.0 * np.eye(6), q, np.diag(r_diag), fx_id=1, hx_id=1)
    hxd = observation.make_hx_imu6(TW)

    x_true = np.array([0.0, 0.0, 0.0, 0.08, 0.0, 0.0])
    fxd = jax_flagship6_fx(dt)
    for t in range(40):
        u = 2.0 * np.sin(0.3 * t)
        x_true = ora_short6(lib, x_true, u, dt, 0.0)
        z = ora_hx(lib, 1, x_true) + r_diag * r.standard_normal(5)
        deltas = lib_deltas(params, np.asarray(est.x), np.asarray(est.p))
        est = lib_predict_with_deltas(params, est, jnp.float64(u), fxd, deltas)
        est = ukf_update(params, est, jnp.asarray(z), hxd)
        ora.predict(u, dt, deltas=deltas)
        ora.update(z)
        # bands: textbook-UT (oracle) vs cancellation-free (library) mean —
        # ~1e-7 on x through the gain, ~1e-6 rel on small P entries.
        np.testing.assert_allclose(np.asarray(est.x), ora.x, atol=1e-5)
        np.testing.assert_allclose(np.asarray(est.p), ora.p, rtol=1e-4, atol=1e-6)
    # the filter actually converged on the true state (sanity, not parity)
    assert abs(float(est.x[3]) - x_true[3]) < 0.05


def test_ukf_cartpole4_chain(lib):
    """UKF(4,3) with the hand-tuned Q/R of mppi4-non-liner-s.rs:210-227."""
    r = np.random.default_rng(37)
    dt = 0.01
    q = np.array([[0.0, 0.0, 0.0, 0.0],
                  [0.0, 0.0, 0.0, 1.0],
                  [0.0, 0.0, 1.0, 1e2],
                  [0.0, 1.0, 1e2, 1e4]])
    r_m = np.diag([50.0, 50.0, 0.5])
    sens = np.array([50.0, 50.0, 0.5])
    params, est = ukf_init(jnp.zeros(4, jnp.float64), jnp.eye(4, dtype=jnp.float64),
                           jnp.asarray(q), jnp.asarray(r_m))
    ora = OraUkf(lib, np.zeros(4), np.eye(4), q, r_m, fx_id=0, hx_id=0)
    hxd = observation.make_hx_rpm_gyro4(SW)
    fxd = jax_cartpole4_fx(dt)
    x_true = np.array([0.0, 0.0, 0.01, 0.0])
    for t in range(40):
        u = 1.5 * np.cos(0.2 * t)
        x_true = ora_dynamics(lib, 0, x_true, u, dt)
        z = ora_hx(lib, 0, x_true) + sens * r.standard_normal(3)
        deltas = lib_deltas(params, np.asarray(est.x), np.asarray(est.p))
        est = lib_predict_with_deltas(params, est, jnp.float64(u), fxd, deltas)
        est = ukf_update(params, est, jnp.asarray(z), hxd)
        ora.predict(u, dt, deltas=deltas)
        ora.update(z)
        # bands: textbook-UT (oracle) vs cancellation-free (library) mean —
        # ~1e-7 on x through the gain, ~1e-6 rel on small P entries.
        np.testing.assert_allclose(np.asarray(est.x), ora.x, atol=1e-5)
        np.testing.assert_allclose(np.asarray(est.p), ora.p, rtol=1e-4, atol=1e-6)


def test_sigma_points_cross_validation(lib):
    """eigh (library) vs Jacobi (oracle) sigma placement on well-separated
    spectra: the two decompositions must produce the same sigma SET up to
    column order and sign (the UT is exactly invariant to both)."""
    rng = np.random.default_rng(53)
    for n in (4, 6):
        params, _ = ukf_init(jnp.zeros(n, jnp.float64), jnp.eye(n, dtype=jnp.float64),
                             jnp.eye(n, dtype=jnp.float64), jnp.eye(n, dtype=jnp.float64))
        for _ in range(8):
            a = rng.standard_normal((n, n))
            qmat, _ = np.linalg.qr(a)
            evals = np.sort(rng.uniform(0.5, 50.0, n))
            while np.min(np.diff(evals)) < 0.5:  # enforce separation
                evals = np.sort(rng.uniform(0.5, 50.0, n))
            pm = qmat @ np.diag(evals) @ qmat.T
            pm = 0.5 * (pm + pm.T)
            x = rng.standard_normal(n)
            d_j = lib_deltas(params, x, pm)  # (n, n) rows
            sig_o = np.empty((2 * n + 1) * n)
            assert lib.oracle_sigma_points(n, _dp(np.ascontiguousarray(x)),
                                           _dp(np.ascontiguousarray(pm)),
                                           _dp(sig_o)) == 0
            d_o = sig_o.reshape(2 * n + 1, n)[1:n + 1] - x
            # greedy one-to-one match up to sign
            used = set()
            for i in range(n):
                best, bj = None, None
                for j in range(n):
                    if j in used:
                        continue
                    dev = min(np.max(np.abs(d_o[i] - d_j[j])),
                              np.max(np.abs(d_o[i] + d_j[j])))
                    if best is None or dev < best:
                        best, bj = dev, j
                assert best < 1e-8, (i, best)
                used.add(bj)


def test_ukf_sqrt_methods_agree_behaviorally(lib):
    """Free-running eigh-filter (library) vs Jacobi-filter (oracle), each
    with its OWN square root, over the 40-step flagship chain: on
    near-degenerate covariances the per-step states may transiently differ
    (ill-defined eigenbasis), but both filters must converge to the same
    estimate — the behavioral claim backing the library's sqrt_method
    equivalence (DESIGN.md §5)."""
    r = np.random.default_rng(31)
    dt = 0.009
    r_diag = np.array([200.0, 200.0, 10.0, 0.05, 0.05])
    q = np.empty(36)
    lib.oracle_gen_q6(dt, _dp(q))
    q = q.reshape(6, 6)
    params, est = ukf_init(jnp.zeros(6, jnp.float64), 10.0 * jnp.eye(6, dtype=jnp.float64),
                           jnp.asarray(q), jnp.diag(jnp.asarray(r_diag)))
    ora = OraUkf(lib, np.zeros(6), 10.0 * np.eye(6), q, np.diag(r_diag), fx_id=1, hx_id=1)
    hxd = observation.make_hx_imu6(TW)
    fxd = jax_flagship6_fx(dt)
    x_true = np.array([0.0, 0.0, 0.0, 0.08, 0.0, 0.0])
    for t in range(40):
        u = 2.0 * np.sin(0.3 * t)
        x_true = ora_short6(lib, x_true, u, dt, 0.0)
        z = ora_hx(lib, 1, x_true) + r_diag * r.standard_normal(5)
        est = ukf_predict(params, est, jnp.float64(u), fxd)
        est = ukf_update(params, est, jnp.asarray(z), hxd)
        ora.predict(u, dt)
        ora.update(z)
        np.testing.assert_allclose(np.asarray(est.x), ora.x, atol=0.35)
    np.testing.assert_allclose(np.asarray(est.x), ora.x, atol=1e-2)
    np.testing.assert_allclose(np.asarray(est.p), ora.p, atol=1e-3)


# ---------------------------------------------------------------------------
# Full closed loop: the flagship configuration, co-simulated
# ---------------------------------------------------------------------------

def test_closed_loop_flagship_cosim(lib):
    """The flagship closed loop (plant + noisy IMU + UKF2(6,5) + MPPI, with
    the 2 N pulse during t ∈ (1.0, 1.5) s) cross-validated against the
    oracle at the fleet\'s gate-validated operating point (apps/fleet.py
    flagship6: 100 Hz control+sensor, K=8192, p0=0.1·I, q=gen_q6(2.15·dt),
    the reference\'s σ-as-R) — the BASELINE.md item 2 surrogate for
    examples/mppi4-non-liner-ukf.rs:224-288.

    Structure: the ORACLE free-runs the loop; at every tick the JAX library
    recomputes each stage from the oracle\'s pre-tick state — the MPPI solve
    (same warm start, same noise), the plant step, and the UKF
    predict/update (matched sigma square root — see the chain tests for
    why the sqrt is shared as data) — and must reproduce the oracle\'s
    outputs tightly.
    Re-synchronizing per tick is deliberate: at this config MPPI\'s softmax
    is near-argmax (tiny ESS), so free-running f64 twins chaotically
    amplify 1e-14 reduction-order differences within ~10 ticks; per-stage
    agreement along the whole 300-tick trajectory is the meaningful (and
    much stricter per-op) parity statement. Free-running compounding is
    covered by test_mppi_warm_started_chain at a gentler config."""
    r = np.random.default_rng(41)
    k, n = 8192, 8
    dt = 0.01            # 100 Hz plant/sensor/control
    dt_model = 1.2 / 8   # controller\'s internal rollout step (T=1.2, N=8)
    r_diag = np.array([200.0, 200.0, 10.0, 0.05, 0.05])
    q = np.empty(36)
    lib.oracle_gen_q6(2.15 * dt, _dp(q))
    q = q.reshape(6, 6)

    params, _ = ukf_init(jnp.zeros(6, jnp.float64), 0.1 * jnp.eye(6, dtype=jnp.float64),
                         jnp.asarray(q), jnp.diag(jnp.asarray(r_diag)))
    from mpc_rs_jax.estimators.ukf import UkfState
    ora = OraUkf(lib, np.zeros(6), 0.1 * np.eye(6), q, np.diag(r_diag), fx_id=1, hx_id=1)
    hx6 = observation.make_hx_imu6(TW)
    fxd = jax_flagship6_fx(dt)
    step6 = dynamics.make_flagship6(TW)

    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=1.4, std_dev=4.0,
                     limit=(-10.0, 10.0))
    ctrl_step = dynamics.make_flagship4(TW, dt_model)
    cost = costs.make_diag4(0.1, 0.1, 1.0, 0.5)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def solve(x4, u_n, eps):
        return mppi_solve(cfg, ctrl_step, cost, key, tuple(x4[i] for i in range(4)),
                          u_n, noise=eps)

    @jax.jit
    def est_step(x, p, u, z, deltas):
        st = UkfState(x=x, p=p, q=jnp.asarray(q), r=jnp.diag(jnp.asarray(r_diag)),
                      sigma_f=jnp.zeros((13, 6), jnp.float64))
        st = lib_predict_with_deltas(params, st, u, fxd, deltas)
        st = ukf_update(params, st, z, hx6)
        return st.x, st.p

    x_plant = np.zeros(6)
    u_n = np.zeros(n)
    n_ticks = 300  # 3 s — pulse + recovery, the fleet gate\'s horizon
    max_du = max_dx = max_de = 0.0
    for tick in range(n_ticks):
        eps = cfg.std_dev * r.standard_normal((k, n))
        # --- MPPI from the oracle\'s pre-tick estimate + warm start
        res = solve(jnp.asarray(ora.x[[0, 1, 3, 4]]), jnp.asarray(u_n), jnp.asarray(eps))
        u_o, st_o = ora_mppi(lib, 2, 1, ora.x[[0, 1, 3, 4]], u_n, eps,
                             CFGF["lam"], CFGF["sigma"], CFGF["limit"], dt_model)
        assert int(res.status) == st_o == 0
        max_du = max(max_du, float(np.max(np.abs(np.asarray(res.u_n) - u_o))))
        u_n = u_o  # re-sync warm start
        # --- plant step under the pulse
        t_now = tick * dt
        f = 2.0 if 1.0 < t_now < 1.5 else 0.0  # mppi4-non-liner-ukf.rs:237-247
        xj = np.array([float(v) for v in
                       step6(*_f64(*x_plant), jnp.float64(u_n[0]), jnp.float64(dt), jnp.float64(f))])
        x_plant = ora_short6(lib, x_plant, u_n[0], dt, f)
        max_dx = max(max_dx, float(np.max(np.abs(xj - x_plant))))
        # --- sensor + UKF from the oracle\'s pre-tick filter state
        z = ora_hx(lib, 1, x_plant) + r_diag * r.standard_normal(5)
        # snapshot: jnp.asarray on CPU may alias the numpy buffer zero-copy,
        # and ora.predict/update mutate ora.x/ora.p in place while the
        # async jitted est_step may still be reading them
        x_pre, p_pre = ora.x.copy(), ora.p.copy()
        deltas = lib_deltas(params, x_pre, p_pre)  # matched sqrt (see chains)
        ex, ep = est_step(jnp.asarray(x_pre), jnp.asarray(p_pre), jnp.float64(u_n[0]),
                          jnp.asarray(z), jnp.asarray(deltas))
        ora.predict(u_n[0], dt, deltas=deltas)
        ora.update(z)
        max_de = max(max_de, float(np.max(np.abs(np.asarray(ex) - ora.x))))
        # noise floor: the oracle uses the textbook UT mean (Σ wm σ) whose
        # f64 cancellation at α=1e-3 leaves ~3e-8 abs / ~1e-6 rel on P
        # (measured along this trajectory); bands carry ~30x headroom.
        np.testing.assert_allclose(np.asarray(ep), ora.p, rtol=1e-4, atol=1e-6)
        # survival along the way (the reference\'s π/2 guard)
        assert abs(x_plant[3]) < np.pi / 2
    assert max_du < 1e-7, max_du   # 300 whole solves, all tight
    assert max_dx < 1e-10, max_dx  # 300 plant steps
    assert max_de < 1e-5, max_de   # 300 filter steps (matched sqrt; textbook-UT noise)


def test_closed_loop_cartpole4_cosim(lib):
    """The mppi4-non-liner-s loop (cartpole4 plant + rpm/gyro sensor +
    UKF(4,3) with the hand-tuned Q/R + MPPI) cross-validated against the
    oracle at the fleet's cartpole4 cadence (apps/fleet.py: 20 Hz control,
    100 Hz plant/sensor substeps). Same per-stage re-synchronized structure
    as the flagship co-sim (see its docstring for why)."""
    r = np.random.default_rng(47)
    k, n = 4096, 8
    dt_tick, sub = 0.05, 5
    dt_s = dt_tick / sub
    dt_model = 0.8 / 8  # controller's rollout step — mppi4-non-liner-s.rs:12-14
    # the fleet's validated estimator point: dt-scaled piecewise-white-noise
    # Q (the reference's hand-tuned constant Q is rate-fragile — STATUS r2),
    # proper variance R. Q/R are shared DATA here; gen_q4 itself is pinned
    # by test_transcription.
    q = np.asarray(noise_mod.gen_q4(jnp.float64(dt_s)))
    sens = np.array([50.0, 50.0, 0.5])    # mppi4-non-liner-s.rs:231-240
    r_m = np.diag(sens * sens)

    x0 = np.array([0.5, 0.0, 0.1, 0.0])  # mppi4.rs:30 / fleet x0
    from mpc_rs_jax.estimators.ukf import UkfState
    params, _ = ukf_init(jnp.asarray(x0), 0.1 * jnp.eye(4, dtype=jnp.float64),
                         jnp.asarray(q), jnp.asarray(r_m))
    ora = OraUkf(lib, x0, 0.1 * np.eye(4), q, r_m, fx_id=0, hx_id=0)
    hx4 = observation.make_hx_rpm_gyro4(SW)
    fxd = jax_cartpole4_fx(dt_s)
    step4 = dynamics.make_cartpole_nonlinear(SW, None)

    # λ=0.5, σ(R)=10, limit ±10 — mppi4-non-liner-s.rs:17-22
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=0.5, std_dev=10.0,
                     limit=(-10.0, 10.0))
    ctrl_step = dynamics.make_cartpole_nonlinear(SW, dt_model)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def solve(x4, u_n, eps):
        return mppi_solve(cfg, ctrl_step, costs.shaped4, key,
                          tuple(x4[i] for i in range(4)), u_n, noise=eps)

    @jax.jit
    def est_step(x, p, u, z, deltas):
        st = UkfState(x=x, p=p, q=jnp.asarray(q), r=jnp.asarray(r_m),
                      sigma_f=jnp.zeros((9, 4), jnp.float64))
        st = lib_predict_with_deltas(params, st, u, fxd, deltas)
        st = ukf_update(params, st, z, hx4)
        return st.x, st.p

    x_plant = x0.copy()
    u_n = np.zeros(n)
    n_ticks = 60  # 3 s at 20 Hz
    max_du = max_dx = max_de = 0.0
    for tick in range(n_ticks):
        eps = cfg.std_dev * r.standard_normal((k, n))
        res = solve(jnp.asarray(ora.x), jnp.asarray(u_n), jnp.asarray(eps))
        u_o, st_o = ora_mppi(lib, 0, 0, ora.x, u_n, eps, cfg.lambda_,
                             cfg.std_dev, cfg.limit, dt_model)
        assert int(res.status) == st_o == 0
        max_du = max(max_du, float(np.max(np.abs(np.asarray(res.u_n) - u_o))))
        u_n = u_o
        for s in range(sub):
            xj = np.array([float(v) for v in
                           step4(*_f64(*x_plant), jnp.float64(u_n[0]), jnp.float64(dt_s))])
            x_plant = ora_dynamics(lib, 0, x_plant, u_n[0], dt_s)
            max_dx = max(max_dx, float(np.max(np.abs(xj - x_plant))))
            z = ora_hx(lib, 0, x_plant) + sens * r.standard_normal(3)
            x_pre, p_pre = ora.x.copy(), ora.p.copy()  # see flagship co-sim
            deltas = lib_deltas(params, x_pre, p_pre)  # matched sqrt
            ex, _ = est_step(jnp.asarray(x_pre), jnp.asarray(p_pre),
                             jnp.float64(u_n[0]), jnp.asarray(z), jnp.asarray(deltas))
            ora.predict(u_n[0], dt_s, deltas=deltas)
            ora.update(z)
            max_de = max(max_de, float(np.max(np.abs(np.asarray(ex) - ora.x))))
        assert abs(x_plant[2]) < np.radians(60.0)  # the reference's 60° guard
    assert max_du < 1e-7, max_du
    assert max_dx < 1e-10, max_dx
    assert max_de < 1e-5, max_de  # matched sqrt; textbook-UT noise


# ---------------------------------------------------------------------------
# Gradient-MPC: condensed-QP cost/grad + exact box-QP solve
# ---------------------------------------------------------------------------

def test_qp_cost_grad_cross_validation(lib):
    """The op-mpc-x-calc condensed-QP cost and analytic gradient
    (examples/op-mpc-x-calc.rs:73-98) — library vs the oracle's from-scratch
    F/G/Q construction from its own literals (incl. the reference's
    rebuild-per-call semantics and column-major x_ref flattening)."""
    from mpc_rs_jax.controllers.qp import build_condensed_qp, qp_cost, qp_grad
    from mpc_rs_jax.models import reference
    lib.oracle_qp_cost_grad.argtypes = [_D, _D, _D, _D]
    lib.oracle_qp_solve_box.restype = ctypes.c_int
    lib.oracle_qp_solve_box.argtypes = [_D, ctypes.c_double, ctypes.c_double, _D]
    a, b = dynamics.linear_ab(SW, 0.1)
    qp = build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), 8)
    gen_ref = reference.make_gen_ref_raised_cosine(8)
    r = np.random.default_rng(59)
    for _ in range(16):
        x = r.uniform(-1.0, 1.0, 4) * np.array([2.0, 1.0, 0.3, 1.0])
        u = r.uniform(-20.0, 20.0, 8)
        xr = jnp.asarray(gen_ref(jnp.asarray(x))).reshape(-1)
        c_lib = float(qp_cost(qp, jnp.asarray(x), jnp.asarray(u), xr))
        g_lib = np.asarray(qp_grad(qp, jnp.asarray(x), jnp.asarray(u), xr))
        c_o = np.empty(1)
        g_o = np.empty(8)
        lib.oracle_qp_cost_grad(_dp(np.ascontiguousarray(x)),
                                _dp(np.ascontiguousarray(u)), _dp(c_o), _dp(g_o))
        np.testing.assert_allclose(c_lib, c_o[0], rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(g_lib, g_o, rtol=1e-10, atol=1e-12)


def test_box_qp_newton_vs_exact_kkt_enumeration(lib):
    """controllers/qp.py box_qp_newton (the QP fleet's production solver,
    both solve paths) vs the oracle's brute-force 3^N active-set KKT
    enumeration — the exact global minimizer of the convex box QP. States
    are scaled so some solves saturate the ±30 bounds and some are
    interior."""
    from mpc_rs_jax.controllers.qp import (active_set_inverse_table,
                                           box_qp_newton, build_condensed_qp,
                                           qp_linear_term)
    from mpc_rs_jax.models import reference
    lib.oracle_qp_solve_box.restype = ctypes.c_int
    lib.oracle_qp_solve_box.argtypes = [_D, ctypes.c_double, ctypes.c_double, _D]
    a, b = dynamics.linear_ab(SW, 0.1)
    qp = build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), 8)
    gen_ref = reference.make_gen_ref_raised_cosine(8)
    tbl = active_set_inverse_table(qp.h)
    r = np.random.default_rng(61)
    n_saturated = 0
    for trial in range(12):
        scale = 8.0 if trial % 3 == 0 else 1.0  # force some bound-active solves
        x = scale * r.uniform(-1.0, 1.0, 4) * np.array([2.0, 1.0, 0.3, 1.0])
        xr = jnp.asarray(gen_ref(jnp.asarray(x))).reshape(-1)
        bvec = qp_linear_term(qp, jnp.asarray(x), xr)
        u_o = np.empty(8)
        assert lib.oracle_qp_solve_box(_dp(np.ascontiguousarray(x)), -30.0, 30.0,
                                       _dp(u_o)) == 0
        n_saturated += int(np.any(np.abs(u_o) >= 29.999))
        for inv in (None, tbl):
            u_lib = np.asarray(box_qp_newton(qp.h, bvec, jnp.zeros(8, jnp.float64),
                                             -30.0, 30.0, inv_table=inv))
            np.testing.assert_allclose(u_lib, u_o, rtol=1e-8, atol=1e-9)
            # the QP fleet's exact production flags (apps/fleet.py
            # solve_batch: safeguard=False, iters=12) must also land on the
            # enumerated optimum on this instance class — pins the fleet's
            # safeguard opt-out to evidence (ADVICE r4).
            u_fleet = np.asarray(box_qp_newton(qp.h, bvec, jnp.zeros(8, jnp.float64),
                                               -30.0, 30.0, iters=12,
                                               inv_table=inv, safeguard=False))
            np.testing.assert_allclose(u_fleet, u_o, rtol=1e-8, atol=1e-9)
    assert n_saturated >= 2  # the bound-active regime was actually exercised


def test_panoc_vs_exact_kkt_enumeration(lib):
    """panoc_solve (the general-purpose solver, examples' default) on the
    op-mpc-x-calc condensed QP vs the oracle's exact KKT enumerator: the
    convex problem has one global minimizer, so a converged PANOC run must
    land on it — interior and bound-saturated states both."""
    from mpc_rs_jax.controllers.panoc import PanocConfig, box_projection, panoc_solve
    from mpc_rs_jax.controllers.qp import build_condensed_qp, make_qp_value_and_grad
    from mpc_rs_jax.models import reference
    lib.oracle_qp_solve_box.restype = ctypes.c_int
    lib.oracle_qp_solve_box.argtypes = [_D, ctypes.c_double, ctypes.c_double, _D]
    a, b = dynamics.linear_ab(SW, 0.1)
    qp = build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), 8)
    gen_ref = reference.make_gen_ref_raised_cosine(8)
    vg_factory = make_qp_value_and_grad(qp, gen_ref)
    cfg = PanocConfig(tol=1e-9, max_iter=200, lbfgs_mem=20)
    proj = box_projection(-30.0, 30.0)
    r = np.random.default_rng(67)
    for trial in range(6):
        scale = 8.0 if trial % 3 == 0 else 1.0
        x = scale * r.uniform(-1.0, 1.0, 4) * np.array([2.0, 1.0, 0.3, 1.0])
        u_o = np.empty(8)
        assert lib.oracle_qp_solve_box(_dp(np.ascontiguousarray(x)), -30.0, 30.0,
                                       _dp(u_o)) == 0
        res = panoc_solve(cfg, None, proj, jnp.zeros(8, jnp.float64),
                          value_and_grad=vg_factory(jnp.asarray(x)))
        np.testing.assert_allclose(np.asarray(res.u), u_o, rtol=1e-6, atol=1e-7)


def test_pallas_kernel_vs_native_oracle(lib):
    """The fused kernel (interpret mode, external noise) vs the independent
    C++ oracle on IDENTICAL (K, N) samples. The f32 kernel must reproduce
    the f64 oracle's solve within the f32 band measured for the vmap
    path."""
    from mpc_rs_jax.ops.mppi_pallas import mppi_solve_pallas
    r = np.random.default_rng(71)
    k, n = 1024, 8
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=CFG4["lam"],
                     std_dev=CFG4["sigma"], limit=CFG4["limit"])
    step = dynamics.make_cartpole_nonlinear(SW, CFG4["dt"])
    x0 = np.array([0.5, 0.0, 0.1, 0.0])
    u_n = np.zeros(n, np.float32)
    x = jnp.asarray(x0, jnp.float32)
    for t in range(5):  # a short warm-started closed loop through the kernel
        eps2d = (CFG4["sigma"] * r.standard_normal((k, n))).astype(np.float32)
        u_pl, st = mppi_solve_pallas(cfg, step, costs.shaped4, 4, 0, x,
                                     jnp.asarray(u_n), interpret=True,
                                     noise=jnp.asarray(eps2d))
        assert int(st) == 0
        u_o, st_o = ora_mppi(lib, 0, 0, np.asarray(x, np.float64), u_n.astype(np.float64),
                             eps2d.astype(np.float64), **CFG4)
        assert st_o == 0
        np.testing.assert_allclose(np.asarray(u_pl, np.float64), u_o, atol=5e-3)
        u_n = np.asarray(u_pl)
        x = jnp.stack(step(*(x[j] for j in range(4)), u_pl[0]))


def test_tracking_cost_and_shifted_fd_cross_validation(lib):
    """op-mpc-x's nonlinear tracking cost (rollout + quartic errors + cosh
    barrier, examples/op-mpc-x.rs:106-125) and the reference's
    pre-stepped-state numeric gradient (:132-151 — each component
    differentiates the cost from dynamics_cpy(x, u[i]), a quirk replicated
    verbatim by make_shifted_fd_value_and_grad) — library vs oracle."""
    from mpc_rs_jax.controllers.panoc import (make_fd_value_and_grad,
                                              make_shifted_fd_value_and_grad)
    from mpc_rs_jax.models import reference
    from mpc_rs_jax.utils import as_vector_fn
    lib.oracle_tracking_cost.restype = ctypes.c_double
    lib.oracle_tracking_cost.argtypes = [_D, _D, ctypes.c_int]
    lib.oracle_tracking_grad_fd.argtypes = [_D, _D, ctypes.c_int, _D]
    p_light = CartPoleParams.single_wheel_light()
    n = 50
    step = as_vector_fn(dynamics.make_cartpole_linear(p_light, 0.5 / 50), 4)
    pe = reference.make_planning_err(p_light.l)
    cost = costs.make_tracking_rollout_cost(step, pe, [0.0, 9.2, 16.0, 0.5, 0.0],
                                            barrier=1.0)
    ref_fd = make_shifted_fd_value_and_grad(cost, step, eps=1e-3)
    r = np.random.default_rng(73)
    for _ in range(6):
        x = r.uniform(-1.0, 1.0, 4) * np.array([3.0, 1.0, 0.5, 1.0])
        u = r.uniform(-10.0, 10.0, n)
        c_lib = float(cost(jnp.asarray(x), jnp.asarray(u)))
        c_o = lib.oracle_tracking_cost(_dp(np.ascontiguousarray(x)),
                                       _dp(np.ascontiguousarray(u)), n)
        np.testing.assert_allclose(c_lib, c_o, rtol=1e-12)
        _, g_lib = ref_fd(jnp.asarray(x))(jnp.asarray(u))
        g_o = np.empty(n)
        lib.oracle_tracking_grad_fd(_dp(np.ascontiguousarray(x)),
                                    _dp(np.ascontiguousarray(u)), n, _dp(g_o))
        np.testing.assert_allclose(np.asarray(g_lib), g_o, rtol=1e-8, atol=1e-10)
        # the quirk is REAL: the shifted-state FD differs measurably from
        # the true gradient of the same cost (textbook central difference)
        _, g_plain = make_fd_value_and_grad(lambda uu: cost(jnp.asarray(x), uu),
                                            eps=1e-3)(jnp.asarray(u))
        assert float(jnp.max(jnp.abs(g_plain - g_lib))) > 1e-6


def test_closed_loop_qp_parking_cosim(lib):
    """The op-mpc-x-calc-nl parking loop (condensed box QP on the linear
    model, NONLINEAR plant — the model-mismatch benchmark) co-simulated
    against the oracle: the oracle free-runs with its exact 3^N KKT solves
    and its own nonlinear plant; per tick the library's box_qp_newton and
    plant step must reproduce both stages. Ends parked, like the
    acceptance criterion (op-mpc-x.rs:263-266 class)."""
    from mpc_rs_jax.controllers.qp import (active_set_inverse_table,
                                           box_qp_newton, build_condensed_qp,
                                           qp_linear_term)
    from mpc_rs_jax.models import reference
    lib.oracle_qp_solve_box.restype = ctypes.c_int
    lib.oracle_qp_solve_box.argtypes = [_D, ctypes.c_double, ctypes.c_double, _D]
    dt = 0.1
    a, b = dynamics.linear_ab(SW, dt)
    qp = build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), 8)
    gen_ref = reference.make_gen_ref_raised_cosine(8)
    tbl = active_set_inverse_table(qp.h)
    plant = dynamics.make_cartpole_nonlinear(SW, dt)  # nonlinear plant (-nl)
    x = np.array([0.5, 0.0, 0.1, 0.0])
    max_du = max_dx = 0.0
    for tick in range(60):  # 6 s
        u_o = np.empty(8)
        assert lib.oracle_qp_solve_box(_dp(np.ascontiguousarray(x)), -30.0, 30.0,
                                       _dp(u_o)) == 0
        xr = jnp.asarray(gen_ref(jnp.asarray(x))).reshape(-1)
        bvec = qp_linear_term(qp, jnp.asarray(x), xr)
        u_lib = np.asarray(box_qp_newton(qp.h, bvec, jnp.zeros(8, jnp.float64),
                                         -30.0, 30.0, inv_table=tbl))
        max_du = max(max_du, float(np.max(np.abs(u_lib - u_o))))
        # same tick solved with the QP fleet's production flags
        # (safeguard=False, iters=12 — apps/fleet.py): the opt-out stays
        # pinned to the exact enumerator along the whole parking trajectory.
        u_fleet = np.asarray(box_qp_newton(qp.h, bvec, jnp.zeros(8, jnp.float64),
                                           -30.0, 30.0, iters=12,
                                           inv_table=tbl, safeguard=False))
        max_du = max(max_du, float(np.max(np.abs(u_fleet - u_o))))
        xj = np.array([float(v) for v in plant(*_f64(*x), jnp.float64(u_o[0]))])
        x = ora_dynamics(lib, 0, x, u_o[0], dt)
        max_dx = max(max_dx, float(np.max(np.abs(xj - x))))
        assert abs(x[2]) < np.pi / 2
    assert max_du < 1e-8, max_du   # 60 exact QP solves reproduced
    assert max_dx < 1e-12, max_dx  # 60 nonlinear plant steps
    assert abs(x[0]) < 0.3 and abs(x[2]) < 0.1  # parked (acceptance criterion)


def test_sharded_mppi_vs_native_oracle(lib):
    """The multi-device tier (shard_map over an 8-device rollouts mesh, one
    pmax/psum log-sum-exp merge round) vs the oracle on IDENTICAL noise:
    the externally supplied (K, N) samples are sharded row-wise, so the
    distributed partial/merge arithmetic must reproduce the serial C++
    solve. Covers the last execution tier (vmap and the kernel are
    covered above)."""
    from mpc_rs_jax.parallel.mesh import make_mesh
    from mpc_rs_jax.parallel.sharded_mppi import make_sharded_mppi
    n_dev = len(jax.devices())
    assert n_dev >= 8, "conftest provides the 8-device virtual mesh"
    mesh = make_mesh({"rollouts": 8})
    r = np.random.default_rng(79)
    k, n = 4096, 8
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=CFG4["lam"],
                     std_dev=CFG4["sigma"], limit=CFG4["limit"])
    step = dynamics.make_cartpole_nonlinear(SW, CFG4["dt"])
    solve = make_sharded_mppi(cfg, step, costs.shaped4, 4, mesh,
                              backend="jnp", external_noise=True)
    x0 = np.array([0.5, 0.0, 0.1, 0.0])
    u_n = np.zeros(n)
    for t in range(5):
        eps = CFG4["sigma"] * r.standard_normal((k, n))
        u_sh, st = solve(jnp.asarray(eps), jnp.asarray(x0),
                         jnp.asarray(u_n, jnp.float64))
        u_o, st_o = ora_mppi(lib, 0, 0, x0, u_n, eps, **CFG4)
        assert int(st) == st_o == 0
        np.testing.assert_allclose(np.asarray(u_sh, np.float64), u_o,
                                   rtol=1e-9, atol=1e-12)
        u_n = u_o
        x0 = ora_dynamics(lib, 0, x0, u_o[0], CFG4["dt"])


def test_box_qp_newton_random_property_vs_enumerator(lib):
    """Property-level solver validation: 40 random SPD box QPs (varied
    conditioning, bound tightness, and scale) — box_qp_newton (both solve
    paths) must reproduce the oracle's exact 3^N-enumerated global
    minimizer on every instance."""
    from mpc_rs_jax.controllers.qp import active_set_inverse_table, box_qp_newton
    lib.oracle_box_qp_solve_generic.restype = ctypes.c_int
    lib.oracle_box_qp_solve_generic.argtypes = [
        ctypes.c_int, _D, _D, ctypes.c_double, ctypes.c_double, _D,
    ]
    r = np.random.default_rng(83)
    n = 8
    n_active = 0
    for trial in range(40):
        # SPD H with condition number up to ~1e4
        qmat, _ = np.linalg.qr(r.standard_normal((n, n)))
        evals = np.exp(r.uniform(0.0, np.log(10.0 ** r.uniform(1, 4)), n))
        h = qmat @ np.diag(evals) @ qmat.T
        h = 0.5 * (h + h.T)
        b = 10.0 ** r.uniform(-1, 2) * r.standard_normal(n)
        lo, hi = -(10.0 ** r.uniform(-1, 1)), 10.0 ** r.uniform(-1, 1)
        u_o = np.empty(n)
        assert lib.oracle_box_qp_solve_generic(
            n, _dp(np.ascontiguousarray(h)), _dp(np.ascontiguousarray(b)),
            lo, hi, _dp(u_o)) == 0
        n_active += int(np.any((u_o <= lo + 1e-9) | (u_o >= hi - 1e-9)))
        tbl = active_set_inverse_table(jnp.asarray(h))
        for inv in (None, tbl):
            u_lib = np.asarray(box_qp_newton(jnp.asarray(h), jnp.asarray(b),
                                             jnp.zeros(n, jnp.float64), lo, hi,
                                             inv_table=inv))
            np.testing.assert_allclose(u_lib, u_o, rtol=1e-7, atol=1e-9,
                                       err_msg=f"trial {trial} inv={inv is not None}")
    assert n_active >= 10  # the bound-active regime is well represented
