"""Bisect the flagship-est distributional delta: semantics vs precision,
and if precision — which stage.

Round-5 state of evidence (DESIGN §18): every f32 FLEET variant (sampler/
fastmath/sqrt/layout/backend swaps, and obs-normalized) free-runs at
per-episode θ-RMS ≈ 0.167-0.175 while the f64 C++ oracle AND a pure-f64
hand-built library loop both land at ≈ 0.135. That comparison confounds
two axes: precision (f32 vs f64) and harness (make_scenario_step fleet
tick vs the hand-built loop that mirrors the oracle driver tick-for-tick).

This diag runs the HAND-BUILT loop (identical semantics to
scripts/diag_flagship_est_f64.py and the oracle driver in
scripts/parity_dist.py) with per-stage dtypes:

    all-f32    controller+estimator+plant f32   → 0.17 ⇒ precision is real
                                                  0.135 ⇒ fleet-tick semantics
    est-f32    estimator f32, controller+plant f64
    ctrl-f32   controller f32, estimator+plant f64
    plant-f32  plant f32, controller+estimator f64

Run: python scripts/diag_flagship_est_bisect.py <variant> [episodes=20]
(CPU; x64 enabled; per-episode RMS printed, mean at the end.)
"""

from __future__ import annotations

import sys

import numpy as np

sys.path.insert(0, ".")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from mpc_rs_jax.controllers.mppi import MppiConfig, mppi_solve
from mpc_rs_jax.estimators.ukf import ukf_init, ukf_predict, ukf_update
from mpc_rs_jax.models import costs, dynamics, noise, observation
from mpc_rs_jax.models.params import CartPoleParams

VARIANTS = {
    "all-f32": dict(ctrl=jnp.float32, est=jnp.float32, plant=jnp.float32),
    "all-f64": dict(ctrl=jnp.float64, est=jnp.float64, plant=jnp.float64),
    "est-f32": dict(ctrl=jnp.float64, est=jnp.float32, plant=jnp.float64),
    "ctrl-f32": dict(ctrl=jnp.float32, est=jnp.float64, plant=jnp.float64),
    "plant-f32": dict(ctrl=jnp.float64, est=jnp.float64, plant=jnp.float32),
    # α=1 (classic Julier spread, n+κ=3 unchanged): the f32-conditioned
    # sigma set — UT weights O(1) instead of O(1/2α²(n+κ)) = 1.7e5, so f32
    # rounding of the propagated sigma points is no longer amplified into
    # the predicted mean (measured: single-predict f32-vs-f64 deviation
    # drops ~1e6×). all-f64-a1 checks α-insensitivity of the CLOSED-LOOP
    # distribution in exact arithmetic (the parity argument's other half).
    "est-f32-a1": dict(ctrl=jnp.float64, est=jnp.float32, plant=jnp.float64,
                       alpha=1.0),
    "all-f32-a1": dict(ctrl=jnp.float32, est=jnp.float32, plant=jnp.float32,
                       alpha=1.0),
    "all-f64-a1": dict(ctrl=jnp.float64, est=jnp.float64, plant=jnp.float64,
                       alpha=1.0),
}


def main():
    variant = sys.argv[1]
    episodes = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    dt_ctrl, dt_est, dt_plant = (VARIANTS[variant][k]
                                 for k in ("ctrl", "est", "plant"))
    alpha = VARIANTS[variant].get("alpha", 1e-3)
    p = CartPoleParams.two_wheel()
    dt = 0.01
    k, n = 8192, 8
    sens = np.array([200.0, 200.0, 10.0, 0.05, 0.05])
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=1.4, std_dev=4.0,
                     limit=(-10.0, 10.0))
    ctrl_step = dynamics.make_flagship4(p, 1.2 / 8)
    cost = costs.make_diag4(0.1, 0.1, 1.0, 0.5)
    plant6 = dynamics.make_flagship6(p)
    hx = observation.make_hx_imu6(p)
    q = noise.gen_q6(jnp.asarray(2.15 * dt, dt_est))

    @jax.jit
    def solve(key, x4, u_n):
        return mppi_solve(cfg, ctrl_step, cost, key,
                          tuple(x4[i] for i in range(4)), u_n)

    def fxd(xv, uu):
        out = plant6(*(xv[..., i] for i in range(6)), uu,
                     jnp.asarray(dt, dt_est), jnp.asarray(0.0, dt_est))
        return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

    @jax.jit
    def est_tick(state, u, z):
        state = ukf_predict(params0, state, u, fxd)
        return ukf_update(params0, state, z, hx)

    params0, est0 = ukf_init(jnp.zeros(6, dt_est),
                             jnp.asarray(0.1 * np.eye(6), dt_est),
                             q.astype(dt_est),
                             jnp.asarray(np.diag(sens), dt_est),
                             alpha=alpha)

    rms_all = []
    err_all = []
    for ep in range(episodes):
        r = np.random.default_rng(8000 + ep)
        key = jax.random.key(9000 + ep)
        x = np.zeros(6)
        est = est0
        u_n = jnp.zeros(n, dt_ctrl)
        thetas = []
        est_err = []  # per-tick estimate error on the controller slice
        for i in range(1000):
            key, kk = jax.random.split(key)
            x4 = np.asarray(est.x, np.float64)[[0, 1, 3, 4]]
            res = solve(kk, jnp.asarray(x4, dt_ctrl), u_n)
            u_n = res.u_n
            u0 = float(u_n[0])
            t_now = i * dt
            f = 2.0 if 1.0 < t_now < 1.5 else 0.0
            x = np.array([float(v) for v in
                          plant6(*(jnp.asarray(c, dt_plant) for c in x),
                                 jnp.asarray(u0, dt_plant),
                                 jnp.asarray(dt, dt_plant),
                                 jnp.asarray(f, dt_plant))])
            z = np.asarray(hx(jnp.asarray(x)), np.float64) \
                + sens * r.standard_normal(5)
            est = est_tick(est, jnp.asarray(u0, dt_est),
                           jnp.asarray(z, dt_est))
            est_err.append(np.asarray(est.x, np.float64)[[0, 1, 3, 4]]
                           - x[[0, 1, 3, 4]])
            thetas.append(x[3])
            assert abs(x[3]) < np.pi / 2, (ep, i)
        rms = float(np.sqrt(np.mean(np.asarray(thetas) ** 2)))
        rms_all.append(rms)
        # settled estimator error (skip the 1 s convergence transient)
        ee = np.asarray(est_err)[100:]
        err_rms = np.sqrt(np.mean(ee ** 2, axis=0))
        err_all.append(err_rms)
        print(f"[{variant}] ep {ep}: rms_theta {rms:.4f}  est-err rms "
              f"[x dx th dth] {np.array2string(err_rms, precision=4)}",
              flush=True)
    print(f"[{variant}] mean rms_theta over {episodes} eps: "
          f"{np.mean(rms_all):.4f} +- {np.std(rms_all):.4f}")
    print(f"[{variant}] mean settled est-err rms [x dx th dth]: "
          f"{np.array2string(np.mean(err_all, axis=0), precision=5)}")
    print("oracle: 0.1349; f64 twin: 0.1347; f32 fleet tiers: 0.166-0.175")


if __name__ == "__main__":
    main()
