"""Gradient-MPC (PANOC) example runners — parity with examples/op-*.rs,
mpc-ukf-x.rs, mpc-ukf-s.rs."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mpc_rs_jax.apps.common import Elapsed, PI_2, host_device, np_step
from mpc_rs_jax.controllers.panoc import (
    PanocConfig,
    ball2_projection,
    box_projection,
    make_fd_value_and_grad,
    make_shifted_fd_value_and_grad,
    panoc_solve,
)
from mpc_rs_jax.controllers.qp import build_condensed_qp, make_qp_value_and_grad
from mpc_rs_jax.estimators.ukf import ukf_init, ukf_predict, ukf_update
from mpc_rs_jax.models import costs, dynamics, noise, observation, reference
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.runtime.logger import CsvLogger
from mpc_rs_jax.runtime.loop import MultiRateConfig, pulse_disturbance, run_multirate_loop
from mpc_rs_jax.utils import as_vector_fn


def op_en2(args):
    """PANOC smoke test: min u0²+u1² on a unit ball — examples/op-en2.rs."""
    cfg = PanocConfig(tol=1e-6, max_iter=200, lbfgs_mem=10)
    f = lambda u: u[0] ** 2 + u[1] ** 2
    res = panoc_solve(cfg, f, ball2_projection(1.0), jnp.zeros(2))
    print(f"parameters: (r={1.0:.4f}), iters = {int(res.iterations)}")
    print(f"u = [{float(res.u[0]):.6f}, {float(res.u[1]):.6f}]")
    return res


def _retry_solve(solve_fn, u_n, limit):
    """Zero-and-retry on failure/saturation — op-mpc-x.rs:199-218 (bounded)."""
    for _ in range(3):
        res = solve_fn(u_n)
        if int(res.iterations) == 0 or abs(float(res.u[0])) >= limit:
            print(f"\x1b[31mIncorrect States (iters={int(res.iterations)}, "
                  f"u0={float(res.u[0]):.2f}) -> retry\x1b[0m")
            u_n = jnp.zeros_like(u_n)
            continue
        return res.u
    return jnp.zeros_like(u_n)


def op_mpc_x(args):
    """Nonlinear-cost gradient MPC (autodiff replaces the rayon numeric
    gradient; --fd replicates the reference's pre-stepped-state FD scheme
    exactly, quirk included) — examples/op-mpc-x.rs.

    T=0.5 N=50, GAIN=[0,9.2,16,0.5,0], cosh barrier, bounds ±30."""
    p = CartPoleParams.single_wheel_light()
    t_hor, n = 0.5, 50
    dt = t_hor / n
    step = as_vector_fn(dynamics.make_cartpole_linear(p, dt), 4)
    pe = reference.make_planning_err(p.l)
    cost = costs.make_tracking_rollout_cost(step, pe, [0.0, 9.2, 16.0, 0.5, 0.0], barrier=1.0)
    cfg = PanocConfig(tol=1e-6, max_iter=args.max_iter or 60, lbfgs_mem=20)
    proj = box_projection(-30.0, 30.0)
    ref_fd = make_shifted_fd_value_and_grad(cost, step, eps=1e-3)

    @jax.jit
    def tick(x, u):
        f = lambda uu: cost(x, uu)
        vg = ref_fd(x) if args.fd else None
        res = panoc_solve(cfg, f, proj, u, value_and_grad=vg)
        return res

    x = np.array([3.0, 0.0, -0.7, 0.0])
    u = jnp.zeros(n, jnp.float64)
    logger = CsvLogger(f"{args.log_dir}/op-mpc-x/op-mpc-x.csv")
    max_iters = int(10.0 / dt)
    for i in range(max_iters + 1):
        u = _retry_solve(lambda uu: tick(jnp.asarray(x), uu), u, 30.0)
        x_est = np.array(x)
        for e in np.array(u):
            x_est = np.array(step(jnp.asarray(x_est), float(e)))
        x = np.array(step(jnp.asarray(x), float(u[0])))
        print(
            f"{i:4}/{max_iters}, {float(u[0]):7.2f}, "
            f"act: ({x[0]:7.2f},{x[1]:7.2f},{x[2]:7.2f},{x[3]:7.2f}) "
            f"est: ({x_est[0]:7.2f},{x_est[1]:7.2f},{x_est[2]:7.2f},{x_est[3]:7.2f})"
        )
        logger.write_row(i * dt, float(u[0]), x, x_est)
        if abs(x[2]) > PI_2:
            print(f"Error: x[2] = {x[2]} > PI / 2")
            break
    logger.close()
    return x


def _op_mpc_x_calc(args, nonlinear_plant: bool):
    """Condensed-QP gradient MPC — examples/op-mpc-x-calc.rs (linear plant)
    and op-mpc-x-calc-nl.rs (nonlinear plant, model-mismatch benchmark)."""
    p = CartPoleParams.single_wheel()
    t_hor, n = 0.8, 8
    dt = t_hor / n
    a, b = dynamics.linear_ab(p, dt)
    c = np.diag([5.0, 5.0, 1.0, 1.0])
    qp = build_condensed_qp(a, b, c, n)
    gen_ref = reference.make_gen_ref_raised_cosine(n)
    vg_factory = make_qp_value_and_grad(qp, gen_ref)
    cfg = PanocConfig(tol=1e-6, max_iter=args.max_iter or 80, lbfgs_mem=20)
    proj = box_projection(-30.0, 30.0)

    aj = jnp.asarray(a)
    bj = jnp.asarray(b).reshape(-1)

    @jax.jit
    def solve(x, u):
        return panoc_solve(cfg, None, proj, u, value_and_grad=vg_factory(x))

    if nonlinear_plant:
        plant = as_vector_fn(dynamics.make_cartpole_nonlinear(p, dt), 4)
        plant_step = lambda x, u0: np.array(plant(jnp.asarray(x), u0))
    else:
        an, bn = np.array(a), np.array(b).reshape(-1)
        plant_step = lambda x, u0: an @ x + bn * u0

    x = np.array([0.5, 0.0, 0.1, 0.0])
    u = jnp.zeros(n, jnp.float64)
    logger = CsvLogger(f"{args.log_dir}/op-mpc-x/op-mpc-x.csv")
    el = Elapsed()
    max_iters = int(5.0 / dt)
    for i in range(max_iters + 1):
        res = solve(jnp.asarray(x), u)
        u = res.u
        if int(res.iterations) == 0 or abs(float(u[0])) >= 30.0:
            print(f"status is invalid, u[0]: {float(u[0])}")
            break
        x = plant_step(x, float(u[0]))
        x_est = x.copy()
        for e in np.array(u):
            x_est = plant_step(x_est, float(e))
        t = i * dt
        print(f"{t:4.2f}, {float(u[0]):7.2f}, act: ({x[0]:7.2f},{x[1]:7.2f},{x[2]:7.2f},{x[3]:7.2f})")
        logger.write_row(t, float(u[0]), x, x_est)
        if abs(x[2]) > PI_2:
            print("x[2] is over pi/2")
            break
    el.print()
    logger.close()
    return x


def op_mpc_x_calc(args):
    return _op_mpc_x_calc(args, nonlinear_plant=False)


def op_mpc_x_calc_nl(args):
    return _op_mpc_x_calc(args, nonlinear_plant=True)


def mpc_ukf_x(args):
    """PANOC + inline UKF + rate-limited planner + control LPF —
    examples/mpc-ukf-x.rs (T=0.5 N=10, GAIN=[0.5,0.5,16,3,0.1])."""
    p = CartPoleParams.single_wheel_heavy_j()
    t_hor, n = 0.5, 10
    dt = t_hor / n
    step = as_vector_fn(dynamics.make_cartpole_linear(p, dt), 4)
    next_plan = reference.make_next_plan(dt)
    plan_err = reference.make_plan_err(p.l)
    gain = [0.5, 0.5, 16.0, 3.0, 0.1]

    def cost(x0, u_seq):
        def body(carry, u):
            x, plan = carry
            x = step(x, u)
            plan = next_plan(plan)
            e = plan_err(x, plan)
            c = (
                gain[0] * e[0] ** 2 + gain[1] * e[1] ** 4 + gain[2] * e[2] ** 4
                + gain[3] * e[3] ** 4 + gain[4] * u**2
                + 1e-6 * jnp.maximum(jnp.cosh(x[2]) - 1.2, 0.0)
            )
            return (x, plan), c

        (_, _), cs = jax.lax.scan(body, (x0, next_plan(x0)), u_seq)
        return jnp.sum(cs)

    cfg = PanocConfig(tol=1e-6, max_iter=args.max_iter or 100, lbfgs_mem=20)
    proj = box_projection(-30.0, 30.0)

    @jax.jit
    def solve(x, u):
        return panoc_solve(cfg, lambda uu: cost(x, uu), proj, u)

    # UKF(4,2): Q/R from mpc-ukf-x.rs:46-53
    q = jnp.asarray([[0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 1.0]])
    r = jnp.asarray([[0.75, 0.75], [0.75, 0.75]])
    hx = observation.make_hx_vel2()
    params, est = ukf_init(jnp.asarray([0.5, 0.0, -0.15, 0.0]), 10.0 * jnp.eye(4), q, r)

    @jax.jit
    def est_step(state, u, z):
        state = ukf_predict(params, state, u, step)
        return ukf_update(params, state, z, hx)

    rng = np.random.default_rng(args.seed)
    x_act = np.array([0.5, 0.0, -0.15, 0.0])
    u = jnp.zeros(n, jnp.float64)
    u_lpf = 0.0
    logger = CsvLogger(f"{args.log_dir}/op-mpc-x/op-mpc-x.csv")
    max_iters = int(min(args.t_end, 10.0) / dt)
    for i in range(max_iters + 1):
        u = _retry_solve(lambda uu: solve(jnp.asarray(est.x), uu), u, 30.0)
        x_pred = np.array(est.x)
        for e in np.array(u):
            x_pred = np.array(step(jnp.asarray(x_pred), float(e)))
        x_ref = np.array(est.x)
        for _ in range(n):
            x_ref = np.array(next_plan(jnp.asarray(x_ref)))
        u_lpf += (float(u[0]) - u_lpf) * 0.5  # control low-pass (:351-352)
        u = u.at[0].set(u_lpf)
        x_act = np.array(step(jnp.asarray(x_act), u_lpf))
        z = np.array(hx(jnp.asarray(x_act))) + rng.normal(size=2) * [0.75, 0.75]
        est = est_step(est, u_lpf, jnp.asarray(z))
        print(
            f"{u_lpf:7.2f}, act: ({x_act[0]:7.2f},{x_act[1]:7.2f},{x_act[2]:7.2f},{x_act[3]:7.2f}) "
            f"est: ({float(est.x[0]):7.2f},{float(est.x[1]):7.2f},{float(est.x[2]):7.2f},{float(est.x[3]):7.2f})"
        )
        logger.write_row(i * dt, u_lpf, x_act, np.array(est.x), x_pred, x_ref)
        if abs(x_act[2]) > PI_2:
            print(f"Error: x[2] = {x_act[2]} > PI / 2")
            break
    logger.close()
    return x_act


def mpc_ukf_s(args):
    """Threaded sim with library QP macros + UKF2 → multi-rate loop —
    examples/mpc-ukf-s.rs (two-wheel A/B, C=diag(1,1,10,5), gen_ref≡0)."""
    p = CartPoleParams.two_wheel()
    t_hor, n = 1.2, 8
    dt = t_hor / n
    a, b = dynamics.linear_ab(p, dt, two_wheel=True)
    c = np.diag([1.0, 1.0, 10.0, 5.0])
    qp = build_condensed_qp(a, b, c, n)
    gen_ref = reference.make_gen_ref_zero(n)
    vg_factory = make_qp_value_and_grad(qp, gen_ref)
    cfg = PanocConfig(tol=1e-6, max_iter=args.max_iter or 60, lbfgs_mem=20)
    proj = box_projection(-10.0, 10.0)

    @jax.jit
    def solve(x, u):
        return panoc_solve(cfg, None, proj, u, value_and_grad=vg_factory(x))

    plant6 = dynamics.make_accel6(p, with_force=True)
    hx = observation.make_hx_imu6(p)
    r_diag = np.array([200.0, 200.0, 10.0, 0.05, 0.05])
    params, ukf0 = ukf_init(
        jnp.zeros(6, jnp.float32),
        10.0 * jnp.eye(6, dtype=jnp.float32),
        noise.gen_q6(jnp.float32(dt)),
        jnp.diag(jnp.asarray(r_diag, jnp.float32)),
    )

    @jax.jit
    def est_step(state, u, z, dt_est):
        def fxd(xv, uu):
            out = plant6(*(xv[..., i] for i in range(6)), uu, dt_est, 0.0)
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

        state = state._replace(q=noise.gen_q6(dt_est).astype(state.q.dtype))
        state = ukf_predict(params, state, u, fxd)
        return ukf_update(params, state, z, hx)

    rng = np.random.default_rng(args.seed)

    def sensor(rng_, x):
        with host_device():
            z = np.array(hx(jnp.asarray(x, jnp.float32)))
        return z + rng_.normal(size=5) * r_diag

    def controller(key, xh, u_n):
        x4 = jnp.asarray([xh[0], xh[1], xh[3], xh[4]])
        res = solve(x4, u_n.astype(jnp.float64))
        return res.u.astype(jnp.float32), jnp.int32(0)

    mr = MultiRateConfig(
        dt_phys=1e-3,
        sensor_period=9e-3,
        control_period=5e-3,
        log_period=30e-3,
        t_end=args.t_end,
        disturbance=pulse_disturbance(1.0, 1.5, 2.0),
        tip_over=lambda xh: abs(float(xh[3])) > PI_2,
    )
    logger = CsvLogger(f"{args.log_dir}/mpc-ukf/mpc-ukf.csv")
    el = Elapsed()

    def predictor(xh, u_n):
        xp = np.array(xh)
        for i in range(n):
            xp = np_step(plant6, xp, float(u_n[i]), dt, 0.0)
        return xp

    res = run_multirate_loop(
        mr,
        plant_step=lambda x, u, dtp, f: np_step(plant6, x, u, dtp, f),
        sensor=sensor,
        est_predict_update=lambda est, u, z, dte: est_step(est, u, jnp.asarray(z, jnp.float32), dte),
        est_state=lambda est: np.array(est.x, np.float64),
        controller=controller,
        predictor=predictor,
        x0=np.zeros(6),
        u0=jnp.zeros(n, jnp.float32),
        est0=ukf0,
        key=jax.random.key(args.seed),
        rng=rng,
        logger=logger,
        debug_ukf_bypass=not args.use_ukf_estimate,
    )
    logger.close()
    if res.tipped:
        print("θ is over pi/2")
    el.print()
    print(f"survived to t={res.t:.2f}s, solves={res.n_solves}")
    return res
