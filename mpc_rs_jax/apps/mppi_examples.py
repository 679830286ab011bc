"""MPPI example runners — parity with examples/mppi*.rs."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mpc_rs_jax.apps.common import DEG60, PI_2, Elapsed, host_device, make_mppi_solver, np_step
from mpc_rs_jax.controllers.mppi import MppiConfig
from mpc_rs_jax.estimators.ukf import ukf_init, ukf_predict, ukf_update
from mpc_rs_jax.models import costs, dynamics, noise, observation
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.runtime.logger import CsvLogger
from mpc_rs_jax.runtime.loop import MultiRateConfig, pulse_disturbance, run_multirate_loop


def mppi2(args):
    """Inline f32 MPPI on a 2-state double integrator — examples/mppi2.rs.

    T=2, N=40, K=8000, λ=2.5, R=1, limit ±3, cost x0²+x1², 5 s sim.
    mppi2's weighting does not divide the control term by λ
    (control_inv = λ/R reproduces it through the library solver)."""
    t_hor, n, k = 2.0, 40, args.k or 8000
    dt = t_hor / n
    cfg = MppiConfig(
        n_horizon=n, n_rollouts=k, lambda_=2.5, std_dev=1.0, limit=(-3.0, 3.0),
        control_inv=2.5 / 1.0,
    )
    step = dynamics.make_double_integrator(dt)
    solve = make_mppi_solver(cfg, step, costs.quad2, 2, args.backend)
    x = np.array([1.0, 0.0])
    u_n = jnp.zeros(n, jnp.float32)
    t = 0.0
    i = 0
    while t < 5.0:
        u_n, status = solve(args.seed + i, x, u_n)
        x = np_step(step, x, float(u_n[0]))
        print(f"t: {t:.2f}, u: {float(u_n[0]):5.2f}, x: [{x[0]:.2f}, {x[1]:.2f}]")
        if not np.isfinite(u_n[0]):
            break
        t += dt
        i += 1
    return x


def _mppi4_loop(args, step_fn, label):
    """Shared body of mppi4 / mppi4-non-liner (examples/mppi4.rs:29-70)."""
    t_hor, n = 0.8, 8
    dt = t_hor / n
    k = args.k or 800_000
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    solve = make_mppi_solver(cfg, step_fn, costs.shaped4, 4, args.backend)
    x = np.array([0.5, 0.0, 0.1, 0.0])
    u_n = jnp.zeros(n, jnp.float32)
    logger = CsvLogger(f"{args.log_dir}/mppi/mppi.csv")
    el = Elapsed()
    t, i = 0.0, 0
    while t < args.t_end:
        u_n, status = solve(args.seed + i, x, u_n)
        x = np_step(step_fn, x, float(u_n[0]))
        print(
            f"t: {t:.2f}, u: {float(u_n[0]):6.2f}, "
            f"x: [{x[0]:6.2f}, {x[1]:5.2f}, {x[2]:5.2f}, {x[3]:5.2f}]"
        )
        if abs(x[2]) > DEG60:
            print("x[2] is over 60 degrees")
            break
        logger.write_row(t, float(u_n[0]), x)
        t += dt
        i += 1
    el.print()
    logger.close()
    return x


def mppi4(args):
    """Library MPPI, linear 4-state model — examples/mppi4.rs."""
    p = CartPoleParams.single_wheel()
    return _mppi4_loop(args, dynamics.make_cartpole_linear(p, 0.1), "mppi4")


def mppi4_non_liner(args):
    """Nonlinear cart-pole (the primary single-solve benchmark) —
    examples/mppi4-non-liner.rs."""
    p = CartPoleParams.single_wheel()
    return _mppi4_loop(args, dynamics.make_cartpole_nonlinear(p, 0.1), "mppi4-non-liner")


def mppi4_non_liner_s(args):
    """Threaded closed-loop sim → deterministic multi-rate loop —
    examples/mppi4-non-liner-s.rs (K=15e5, σ=10, UKF(4,3), 1 ms sensor)."""
    p = CartPoleParams.single_wheel()
    t_hor, n = 0.8, 8
    dt = t_hor / n
    k = args.k or 1_500_000
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=0.5, std_dev=10.0, limit=(-10.0, 10.0))
    ctrl_step = dynamics.make_cartpole_nonlinear(p, dt)
    solve = make_mppi_solver(cfg, ctrl_step, costs.shaped4, 4, args.backend)
    plant = dynamics.make_cartpole_nonlinear(p, None)  # dt at call time

    hx = observation.make_hx_rpm_gyro4(p)
    if getattr(args, "ref_qr", False):
        # the reference's hand-tuned constants (mppi4-non-liner-s.rs:210-226).
        # Rate-fragile: Q is constant PER PREDICT STEP, so the injected
        # process noise scales with the update rate it was tuned at; at this
        # loop's 333 Hz the θ estimate degrades to ~0.17 rad during fast
        # swings and the closed loop tips within ~1-2 s (round-2 diagnosis —
        # the same filter pins θ̇ to the gyro and survives when Q/R are the
        # dt-scaled piecewise-white-noise/variance forms below).
        q = jnp.asarray(
            [[0, 0, 0, 0], [0, 0, 0, 1.0], [0, 0, 1.0, 1e2], [0, 1.0, 1e2, 1e4]], jnp.float32
        )
        r = jnp.diag(jnp.asarray([50.0, 50.0, 0.5], jnp.float32))
        p0 = jnp.eye(4, dtype=jnp.float32)
    else:
        # default: dt-scaled piecewise-white-noise Q (the same family the
        # reference's own flagship gen_q uses) + statistically consistent
        # R = diag(σ²); survives 10 s at K=16384 where the hand tuning tips
        q = noise.gen_q4(3e-3, (25.0, 400.0)).astype(jnp.float32)
        r = jnp.diag(jnp.asarray([2500.0, 2500.0, 0.25], jnp.float32))
        p0 = 0.1 * jnp.eye(4, dtype=jnp.float32)
    params, ukf0 = ukf_init(jnp.zeros(4, jnp.float32), p0, q, r)
    ukf0 = ukf0._replace(x=jnp.asarray([0.0, 0.0, 0.01, 0.0], jnp.float32))

    @jax.jit
    def est_step(state, u, z, dt_est):
        # vector fx with the tick's dt baked per call:
        def fxd(xv, uu):
            out = plant(*(xv[..., i] for i in range(4)), uu, dt_est)
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

        state = ukf_predict(params, state, u, fxd)
        return ukf_update(params, state, z, hx)

    rng = np.random.default_rng(args.seed)

    def sensor(rng_, x):
        with host_device():
            z = np.array(hx(jnp.asarray(x, jnp.float32)))
        return z + rng_.normal(size=3) * [50.0, 50.0, 0.5]

    mr = MultiRateConfig(
        dt_phys=1e-3,
        sensor_period=3e-3,  # 1 ms latency + 2 ms pacing in the reference
        sensor_latency=1e-3,
        control_period=dt,
        log_period=dt,
        t_end=args.t_end,
        tip_over=lambda xh: abs(float(xh[2])) > DEG60,
    )
    logger = CsvLogger(f"{args.log_dir}/mppi/mppi.csv")
    res = run_multirate_loop(
        mr,
        plant_step=lambda x, u, dtp, f: np_step(plant, x, u, dtp),
        sensor=sensor,
        est_predict_update=lambda est, u, z, dte: est_step(est, u, jnp.asarray(z, jnp.float32), dte),
        est_state=lambda est: np.array(est.x, np.float64),
        controller=lambda key, xh, u_n: solve(int(jax.random.randint(key, (), 0, 2**31 - 1)), xh, u_n),
        predictor=None,
        x0=np.array([0.0, 0.0, 0.01, 0.0]),
        u0=jnp.zeros(n, jnp.float32),
        est0=ukf0,
        key=jax.random.key(args.seed),
        rng=rng,
        logger=logger,
    )
    logger.close()
    print(f"survived to t={res.t:.2f}s, tipped={res.tipped}, solves={res.n_solves}")
    return res


def mppi4_non_liner_ukf(args):
    """Flagship closed-loop sim — examples/mppi4-non-liner-ukf.rs.

    Two-wheel 6-state plant with 2 N push t∈(1,1.5) s, UKF2(6,5) with
    per-tick gen_q, MPPI T=1.2 N=8 K=5e5 λ=1.4 σ=4 limit ±10,
    cost C=[0.1,0.1,1,0.5]; DEBUG_UKF (controller sees true state) is the
    reference default (:31)."""
    p = CartPoleParams.two_wheel()
    t_hor, n = 1.2, 8
    dt = t_hor / n
    k = args.k or 500_000
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=1.4, std_dev=4.0, limit=(-10.0, 10.0))
    cost = costs.make_diag4(0.1, 0.1, 1.0, 0.5)
    ctrl_step = dynamics.make_flagship4(p, dt)
    solve = make_mppi_solver(cfg, ctrl_step, cost, 4, args.backend)
    plant6 = dynamics.make_flagship6(p)

    hx = observation.make_hx_imu6(p)
    r_diag = np.array([200.0, 200.0, 10.0, 0.05, 0.05])
    # With --use-ukf-estimate (a mode the reference never validates — its
    # DEBUG_UKF default feeds true state, :31) the estimator becomes
    # load-bearing: use the fleet-validated settings (P0=0.1, Q at 2.15·dt
    # ≈ 10×, scripts/diag_flagship.py round-2 sweep: survival 1.000 vs
    # 0.953). DEBUG_UKF mode keeps the reference constants verbatim.
    est_in_loop = args.use_ukf_estimate
    q_scale = 2.15 if est_in_loop else 1.0
    # Sigma spread: est-in-loop uses the f32-validated α=1 (the reference's
    # Merwe α=1e-3 amplifies f32 sigma-point rounding ~1.7e5× into the
    # predicted mean — DESIGN §18, distributionally validated against the
    # f64 oracle by scripts/parity_dist.py); DEBUG_UKF keeps the reference
    # constant verbatim (the estimate is not load-bearing there).
    ukf_alpha = getattr(args, "ukf_alpha", None)
    if ukf_alpha is None:
        ukf_alpha = 1.0 if est_in_loop else 1e-3
    params, ukf0 = ukf_init(
        jnp.zeros(6, jnp.float32),
        (0.1 if est_in_loop else 10.0) * jnp.eye(6, dtype=jnp.float32),
        noise.gen_q6(jnp.float32(q_scale * dt)),
        jnp.diag(jnp.asarray(r_diag, jnp.float32)),
        alpha=ukf_alpha,
    )

    @jax.jit
    def est_step(state, u, z, dt_est):
        def fxd(xv, uu):
            out = plant6(*(xv[..., i] for i in range(6)), uu, dt_est, 0.0)
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

        state = state._replace(q=noise.gen_q6(q_scale * dt_est).astype(state.q.dtype))
        state = ukf_predict(params, state, u, fxd)
        return ukf_update(params, state, z, hx)

    rng = np.random.default_rng(args.seed)

    def sensor(rng_, x):
        with host_device():
            z = np.array(hx(jnp.asarray(x, jnp.float32)))
        return z + rng_.normal(size=5) * r_diag

    t0_wall = [None]

    def _t():
        import time as _time

        if t0_wall[0] is None:
            t0_wall[0] = _time.time()
        return _time.time() - t0_wall[0]

    def controller(key, xh, u_n):
        # 6-state estimate → 4-state controller input [x, dx, θ, θ̇] (:78)
        x4 = np.array([xh[0], xh[1], xh[3], xh[4]])
        if abs(x4[2]) > PI_2:
            return u_n, jnp.int32(0)
        seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
        out = solve(seed, x4, u_n)
        # one readback per solve: the loop then indexes the host copy
        u_host = np.asarray(out[0])
        if getattr(args, "console", False):
            from mpc_rs_jax.runtime.console import print_con

            print_con(_t(), float(u_host[0]), x4)
        return u_host, int(out[1])

    def predictor(xh, u_n):
        xp = np.array(xh)
        for i in range(n):
            xp = np_step(plant6, xp, float(u_n[i]), dt, 0.0)
        return xp

    cp = getattr(args, "control_period", None)
    mr = MultiRateConfig(
        dt_phys=1e-3,
        sensor_period=9e-3,
        sensor_latency=0.0,
        control_period=(None if cp == 0 else cp) if cp is not None else 3e-3,
        log_period=30e-3,
        t_end=args.t_end,
        disturbance=pulse_disturbance(1.0, 1.5, 2.0),
        tip_over=lambda xh: abs(float(xh[3])) > PI_2,
    )
    logger = CsvLogger(f"{args.log_dir}/mppi/mppi.csv")
    el = Elapsed()
    def est_update(est, u, z, dte):
        est = est_step(est, u, jnp.asarray(z, jnp.float32), dte)
        if getattr(args, "console", False):
            from mpc_rs_jax.runtime.console import print_rcv

            print_rcv(_t(), u, np.array(est.x), z, p_diag=np.diag(np.array(est.p)))
        return est

    res = run_multirate_loop(
        mr,
        plant_step=lambda x, u, dtp, f: np_step(plant6, x, u, dtp, f),
        sensor=sensor,
        est_predict_update=est_update,
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
