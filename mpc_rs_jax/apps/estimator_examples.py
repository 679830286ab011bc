"""Estimator + PID example runners — the reference's pedagogical ladder
(SURVEY §4.1): scalar KF → 2-state KF → scalar/2/4/6-state UKF → PID."""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mpc_rs_jax.apps.common import DEG60, Elapsed, np_step
from mpc_rs_jax.controllers.pid import PidConfig, pid_init, pid_update
from mpc_rs_jax.estimators.gaussian import Gaussian, kf1d_predict
from mpc_rs_jax.estimators.kf import kf_predict, kf_update_joseph
from mpc_rs_jax.estimators.ukf import ukf_init, ukf_predict, ukf_update
from mpc_rs_jax.models import dynamics, observation
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.runtime.logger import CsvLogger
from mpc_rs_jax.utils import as_vector_fn


class EstRun(NamedTuple):
    """Estimator-example result: final filter state plus the full episode
    history, so acceptance can check est-vs-truth RMSE quantitatively
    (the reference's de-facto check is act-vs-est convergence printed per
    step — examples/ukf-pen2.rs:87-103; VERDICT r4 Next #4)."""

    x: np.ndarray    # final estimate
    p: np.ndarray    # final covariance
    act: np.ndarray  # (T, n) truth trajectory
    est: np.ndarray  # (T, n) estimates (post-update)
    obs: np.ndarray  # (T, m) noisy observations


def one_liner_kf(args):
    """1-D KF with Gaussian algebra, wrong prior — examples/one-liner-kf.rs."""
    rng = np.random.default_rng(args.seed)
    x_act = 0.0
    x_est = Gaussian(jnp.float64(10.0), jnp.float64(10.0))
    for _ in range(100):
        u = 0.5
        x_act += u
        x_est = kf1d_predict(x_est, Gaussian(jnp.float64(u), jnp.float64(1.0)))
        x_obs = Gaussian(jnp.float64(x_act + rng.normal() * 2.0), jnp.float64(4.0))
        x_est = x_est * x_obs
        print(
            f"x_act: {x_act:6.2f}, x_obs: {float(x_obs.mean):6.2f}, "
            f"x_est.mean: {float(x_est.mean):6.2f}, x_est.var: {float(x_est.var):7.3f}"
        )
    return x_est


def two_liner_kf(args):
    """2-state linear KF, Joseph form — examples/two-liner-kf.rs."""
    dt = 0.01
    f = jnp.asarray([[1.0, dt], [0.0, 1.0]])
    q = jnp.asarray([[0.25, 0.5], [0.5, 1.0]])
    h = jnp.asarray([[1.0, 0.0]])
    r = jnp.asarray([[4.0]])
    b = jnp.asarray([[0.0, 0.0], [1.0, -1.0]])
    rng = np.random.default_rng(args.seed)
    x_act = np.zeros(2)
    x_est = jnp.zeros(2)
    p = 100.0 * jnp.eye(2)
    fn, bn = np.array(f), np.array(b)
    for _ in range(100):
        u = np.array([0.5, -0.5])
        x_act = fn @ x_act + bn @ u
        x_est, p = kf_predict(x_est, p, f, q, jnp.asarray(u), b)
        z = jnp.asarray([x_act[0] + rng.normal() * 4.0])
        x_est, p = kf_update_joseph(x_est, p, z, h, r)
        print(
            f"x_act: ({x_act[0]:6.2f},{x_act[1]:6.2f}) x_obs: {float(z[0]):6.2f}, "
            f"x_est: ({float(x_est[0]):6.2f},{float(x_est[1]):6.2f})"
        )
    return x_est, p


def ukf_one(args):
    """Scalar UKF — examples/ukf-one.rs (DT=1, Q=R=1, wrong prior 10/100)."""
    params, state = ukf_init(
        jnp.asarray([10.0]), jnp.asarray([[100.0]]), jnp.asarray([[1.0]]), jnp.asarray([[1.0]])
    )
    fx = lambda x, u: x + u * 1.0
    hx = lambda x: x
    rng = np.random.default_rng(args.seed)
    x_act = 0.0
    hist = []
    for _ in range(100):
        u = 0.5
        x_act += u
        state = ukf_predict(params, state, u, fx)
        z = jnp.asarray([x_act + rng.normal() * 1.0])
        state = ukf_update(params, state, z, hx)
        hist.append(([x_act], np.array(state.x), np.array(z)))
        print(
            f"x_act: {x_act:6.3f} x_obs: {float(z[0]):6.3f} "
            f"x_est: {float(state.x[0]):6.3f} p: {float(state.p[0,0]):6.3f}"
        )
    print("wm:", np.array(params.wm[:3]))
    print("wc:", np.array(params.wc[:3]))
    act, est, obs = (np.array([h[i] for h in hist]) for i in range(3))
    return EstRun(np.array(state.x), np.array(state.p), act, est, obs)


def ukf_two(args):
    """2-state UKF with x1⁴ nonlinearity — examples/ukf-two.rs."""
    dt = 0.1
    q = jnp.asarray([[0.25, 0.5], [0.5, 1.0]])
    r = jnp.asarray([[2.0]])
    params, state = ukf_init(jnp.zeros(2), 10.0 * jnp.eye(2), q, r)

    def fx(x, u):
        x0 = x[..., 0] + x[..., 1] ** 4 * dt
        x1 = x[..., 1] + (u[0] - u[1]) * dt
        return jnp.stack(jnp.broadcast_arrays(x0, x1), axis=-1)

    hx = lambda x: x[..., :1]
    rng = np.random.default_rng(args.seed)
    x_act = np.zeros(2)
    hist = []
    for _ in range(100):
        u = jnp.asarray([0.5, -0.5])
        x_act = np.array([x_act[0] + x_act[1] ** 4 * dt, x_act[1] + (0.5 - -0.5) * dt])
        state = ukf_predict(params, state, u, fx)
        z = jnp.asarray([x_act[0] + rng.normal() * 2.0])
        state = ukf_update(params, state, z, hx)
        hist.append((x_act.copy(), np.array(state.x), np.array(z)))
        print(
            f"x_act: ({x_act[0]:7.2f},{x_act[1]:7.2f}) x_obs: {float(z[0]):7.2f}, "
            f"x_est: ({float(state.x[0]):7.2f},{float(state.x[1]):7.2f})"
        )
    act, est, obs = (np.array([h[i] for h in hist]) for i in range(3))
    return EstRun(np.array(state.x), np.array(state.p), act, est, obs)


def _run_ukf_pen(args, p, q, r_diag, hx, n_state=4, j2_tag=""):
    dt = 0.01
    if n_state == 4:
        fx = as_vector_fn(dynamics.make_cartpole_nonlinear(p, dt), 4)
    else:
        fx = as_vector_fn(dynamics.make_pen6(p, dt), 6)
    params, state = ukf_init(
        jnp.zeros(n_state), 10.0 * jnp.eye(n_state), q, jnp.diag(jnp.asarray(r_diag))
    )
    rng = np.random.default_rng(args.seed)
    x_act = np.zeros(n_state)
    hist = []
    for i in range(100):
        u = 0.1
        x_act = np.array(fx(jnp.asarray(x_act), u))
        state = ukf_predict(params, state, u, fx)
        zv = np.array(hx(jnp.asarray(x_act))) + rng.normal(size=len(r_diag)) * np.asarray(r_diag)
        state = ukf_update(params, state, jnp.asarray(zv), hx)
        hist.append((x_act.copy(), np.array(state.x), zv.copy()))
        print(
            f"t: {i*dt:4.2f} x_act: {np.round(x_act[:4], 2)} "
            f"x_est: {np.round(np.array(state.x[:4]), 2)} "
            f"p: {np.round(np.diag(np.array(state.p))[:4], 2)}"
        )
    act, est, obs = (np.array([h[i] for h in hist]) for i in range(3))
    return EstRun(np.array(state.x), np.array(state.p), act, est, obs)


def ukf_pen(args):
    """4-state pendulum UKF (scratch math = library math) — examples/ukf-pen.rs."""
    p = CartPoleParams.single_wheel_j01()
    q = jnp.asarray([[0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0.25, 0.5], [0, 0, 0.5, 1.0]])
    hx = observation.make_hx_vel2()
    return _run_ukf_pen(args, p, q, [0.5, 0.5], hx, 4)


def ukf_pen2(args):
    """4-state via library UKF, rpm/gyro obs — examples/ukf-pen2.rs."""
    p = CartPoleParams.single_wheel()
    q = jnp.diag(jnp.asarray([0.0, 0.0, 0.0, 0.25]))
    hx = observation.make_hx_rpm_gyro4(p)
    return _run_ukf_pen(args, p, q, [100.0, 100.0, 0.5], hx, 4)


def ukf_pen3(args):
    """6-state via UKF2-dims, force-IMU obs — examples/ukf-pen3.rs."""
    p = CartPoleParams.single_wheel()
    q = jnp.diag(jnp.asarray([0.0, 0.0, 0.0, 0.0, 0.0, 10.0]))
    hx = observation.make_hx_force6(p)
    return _run_ukf_pen(args, p, q, [100.0, 100.0, 0.5, 100.0, 100.0], hx, 6)


def pid(args):
    """PID baseline — examples/pid.rs (VelPid 0.6/0.4/5e-3, ±25)."""
    p = CartPoleParams.single_wheel()
    dt = 1e-3
    step = dynamics.make_cartpole_linear_pid(p, dt)
    cfg = PidConfig(kp=0.6, ki=0.4, kd=5e-3, lo=-25.0, hi=25.0)
    s = pid_init(dtype=jnp.float64)
    x = np.array([-0.5, 0.0, 0.2, 0.0])
    logger = CsvLogger(f"{args.log_dir}/pid/pid.csv")
    el = Elapsed()
    i = 0
    while i * dt < args.t_end:
        t = i * dt
        pp = 0.5
        phase = np.clip(x[0], -pp, pp) * math.pi / pp / 2.0
        theta_ref = -0.2 * math.sin(phase) ** 5
        u, s = pid_update(cfg, s, jnp.float64(theta_ref), jnp.float64(x[2]), dt)
        x = np_step(step, x, -float(u))
        if i % int(0.1 / dt) == 0:
            print(
                f"t: {t:.2f}, r: {theta_ref:8.5f}, u: {float(u):8.3f}, "
                f"x: [{x[0]:10.4f}, {x[1]:6.2f}, {x[2]:5.2f}, {x[3]:5.2f}]"
            )
            logger.write_row(t, float(u), theta_ref, x)
        if abs(x[2]) > DEG60:
            print("x[2] is over 60 degrees")
            break
        i += 1
    el.print()
    logger.close()
    return x
