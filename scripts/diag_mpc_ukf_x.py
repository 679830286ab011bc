"""Reproduce docs/MPC_UKF_X_ANALYSIS.md: the mpc-ukf-x runaway is the
global optimum of the reference's own cost (mpc-ukf-x.rs:222-240).

1. multistart the first-tick solve (24 inits) → unique weak optimum
2. ideal closed loop (true state, no noise, no LPF) → θ-locked glide

Usage: python scripts/diag_mpc_ukf_x.py
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from mpc_rs_jax.controllers.panoc import PanocConfig, box_projection, panoc_solve
from mpc_rs_jax.models import dynamics, reference
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.utils import as_vector_fn

P = CartPoleParams.single_wheel_heavy_j()
N, DT = 10, 0.05
step = as_vector_fn(dynamics.make_cartpole_linear(P, DT), 4)
next_plan = reference.make_next_plan(DT)
plan_err = reference.make_plan_err(P.l)
GAIN = [0.5, 0.5, 16.0, 3.0, 0.1]  # mpc-ukf-x.rs:217


def cost(x0, u_seq):
    """mpc-ukf-x.rs:222-240 — plan seeded from the state argument (:227)."""

    def body(carry, u):
        x, plan = carry
        x = step(x, u)
        plan = next_plan(plan)
        e = plan_err(x, plan)
        c = (
            GAIN[0] * e[0] ** 2 + GAIN[1] * e[1] ** 4 + GAIN[2] * e[2] ** 4
            + GAIN[3] * e[3] ** 4 + GAIN[4] * u**2
            + 1e-6 * jnp.maximum(jnp.cosh(x[2]) - 1.2, 0.0)
        )
        return (x, plan), c

    (_, _), cs = jax.lax.scan(body, (x0, next_plan(x0)), u_seq)
    return jnp.sum(cs)


def main():
    cfg = PanocConfig(tol=1e-10, max_iter=20000, lbfgs_mem=20)
    cfg_cl = PanocConfig(tol=1e-9, max_iter=2000, lbfgs_mem=20)
    proj = box_projection(-30.0, 30.0)
    x0 = jnp.asarray([0.5, 0.0, -0.15, 0.0])  # mpc-ukf-x.rs:279

    print("== multistart first-tick solve ==")
    rng = np.random.default_rng(0)
    inits = [jnp.zeros(N), jnp.full((N,), -30.0), jnp.full((N,), 30.0)] + [
        jnp.asarray(rng.uniform(-30, 30, N)) for _ in range(9)
    ]
    sols = []
    for u0 in inits:
        r = panoc_solve(cfg, lambda uu: cost(x0, uu), proj, u0)
        u = np.array(r.u if hasattr(r, "u") else r[0])
        sols.append((float(cost(x0, jnp.asarray(u))), u))
    costs_found = sorted(c for c, _ in sols)
    print(f"  {len(sols)} starts, cost range [{costs_found[0]:.6f}, {costs_found[-1]:.6f}]")
    best = min(sols, key=lambda s: s[0])
    print(f"  u* = {np.array2string(best[1], precision=3)}")
    assert costs_found[-1] - costs_found[0] < 1e-6, "multiple minima found!"
    assert abs(best[1][0]) < 1.0, "optimum is not the weak action?"

    print("== ideal closed loop (true state, no noise, no LPF) ==")
    x, u_n = x0, jnp.zeros(N)
    for i in range(150):
        r = panoc_solve(cfg_cl, lambda uu: cost(x, uu), proj, u_n)
        u_n = r.u if hasattr(r, "u") else r[0]
        x = step(x, float(u_n[0]))
        if i % 30 == 0:
            print(f"  t={i*DT:4.1f}  u={float(u_n[0]):7.3f}  x={np.array2string(np.array(x), precision=3)}")
    th = float(x[2])
    print(f"  final: x={float(x[0]):.1f} m, theta={th:.3f} rad (|theta|<pi/2: guard never fires)")
    assert abs(th) < np.pi / 2 and abs(float(x[0])) > 10.0, "expected the theta-locked glide"
    print("CONFIRMED: runaway is the cost's own optimum (see docs/MPC_UKF_X_ANALYSIS.md)")


if __name__ == "__main__":
    main()
