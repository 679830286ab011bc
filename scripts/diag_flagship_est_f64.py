"""Is the flagship-est distributional delta an f32 effect or a semantic
one? (follow-up to diag_flagship_est_dist.py)

Every library fleet variant — including the reference tier (threefry
normals, exact transcendentals, eigh root, AoS layout) — lands at
per-episode θ-RMS ≈ 0.17 while the f64 oracle free-runs at ≈ 0.135, so
the fast tiers are NOT the cause. This diag free-runs the SAME loop in
pure f64 built directly from library pieces (ukf_init/ukf_predict/
ukf_update + mppi_solve, exact dynamics), matching the fleet cadence.

If f64-library ≈ 0.135 → the delta is f32 precision in the estimator
path (production finding). If f64-library ≈ 0.17 → the fleet tick and
the oracle driver differ semantically somewhere (bug hunt).

Run: python scripts/diag_flagship_est_f64.py [episodes=20]
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


def main():
    episodes = int(sys.argv[1]) if len(sys.argv) > 1 else 20
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
    q = noise.gen_q6(jnp.float64(2.15 * dt))

    @jax.jit
    def solve(key, x4, u_n):
        return mppi_solve(cfg, ctrl_step, cost, key,
                          tuple(x4[i] for i in range(4)), u_n)

    def fxd(xv, uu):
        out = plant6(*(xv[..., i] for i in range(6)), uu, jnp.float64(dt),
                     jnp.float64(0.0))
        return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

    @jax.jit
    def est_tick(state, u, z):
        state = ukf_predict(params0, state, u, fxd)
        return ukf_update(params0, state, z, hx)

    params0, est0 = ukf_init(jnp.zeros(6, jnp.float64),
                             0.1 * jnp.eye(6, dtype=jnp.float64),
                             q, jnp.diag(jnp.asarray(sens)))

    rms_all = []
    for ep in range(episodes):
        r = np.random.default_rng(8000 + ep)
        key = jax.random.key(9000 + ep)
        x = np.zeros(6)
        est = est0
        u_n = jnp.zeros(n, jnp.float64)
        thetas = []
        for i in range(1000):
            key, kk = jax.random.split(key)
            x4 = np.asarray(est.x)[[0, 1, 3, 4]]
            res = solve(kk, jnp.asarray(x4), u_n)
            u_n = res.u_n
            u0 = float(u_n[0])
            t_now = i * dt
            f = 2.0 if 1.0 < t_now < 1.5 else 0.0
            x = np.array([float(v) for v in
                          plant6(*(jnp.float64(c) for c in x), jnp.float64(u0),
                                 jnp.float64(dt), jnp.float64(f))])
            z = np.asarray(hx(jnp.asarray(x))) + sens * r.standard_normal(5)
            est = est_tick(est, jnp.float64(u0), jnp.asarray(z))
            thetas.append(x[3])
            assert abs(x[3]) < np.pi / 2, (ep, i)
        rms = float(np.sqrt(np.mean(np.asarray(thetas) ** 2)))
        rms_all.append(rms)
        print(f"ep {ep}: rms_theta {rms:.4f}", flush=True)
    print(f"f64 library mean rms_theta over {episodes} eps: "
          f"{np.mean(rms_all):.4f} +- {np.std(rms_all):.4f}")
    print("oracle reference: 0.1349; f32 fleet tiers: ~0.166-0.175")


if __name__ == "__main__":
    main()
