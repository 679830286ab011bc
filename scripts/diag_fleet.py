"""Diagnose cartpole4 fleet survival (VERDICT round-1 Weak #2).

Round-1 finding: the fleet ran plant = controller model (one Euler step at
dt=0.1) and a 10 Hz sensor — an operating point the reference never uses.
With an accurately integrated plant (substeps) the reference's closed-loop
config for this plant is mppi4-non-liner-s.rs (σ=10, limit ±10, ~kHz
sensor); this script searches the fleet operating point that survives at
matched sensor noise σ=[50,50,0.5].

Usage: python scripts/diag_fleet.py [B] [K] [TICKS]
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from mpc_rs_jax.controllers.mppi import MppiConfig
from mpc_rs_jax.estimators.ukf import ukf_init
from mpc_rs_jax.models import costs, dynamics, noise, observation
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.parallel.mesh import make_mesh
from mpc_rs_jax.parallel.scenario import init_scenario_carry, make_scenario_step
from mpc_rs_jax.utils import as_vector_fn

B = int(sys.argv[1]) if len(sys.argv) > 1 else 256
K = int(sys.argv[2]) if len(sys.argv) > 2 else 256
TICKS = int(sys.argv[3]) if len(sys.argv) > 3 else 50

p = CartPoleParams.single_wheel()
DT = 0.1
hx = observation.make_hx_rpm_gyro4(p)
MESH = make_mesh({"scenario": 1, "rollouts": 1}, devices=jax.devices()[:1])

SIG_REF = jnp.asarray([50.0, 50.0, 0.5], jnp.float32)
Q_HAND = jnp.asarray(
    [[0, 0, 0, 0], [0, 0, 0, 1.0], [0, 0, 1.0, 1e2], [0, 1.0, 1e2, 1e4]], jnp.float32
)
R_SIGMA = jnp.diag(SIG_REF)  # the reference's R (σ, not σ²)
R_VAR = jnp.diag(SIG_REF * SIG_REF)  # statistically consistent R


def run(name, q, r, sig, cfg, *, x0=(0.5, 0.0, 0.1, 0.0), true_state=False, substeps=1,
        est_x0=None, dt=DT, ticks=None):
    ticks = ticks or TICKS
    x0 = jnp.asarray(x0, jnp.float32)
    # controller's horizon step stays T/N=0.1 (the reference's model step);
    # the control tick (plant advance per solve) may be faster, as in the
    # reference's unthrottled control threads
    step = dynamics.make_cartpole_nonlinear(p, DT)
    fx = as_vector_fn(dynamics.make_cartpole_nonlinear(p, dt / substeps), 4)
    params, ukf0 = ukf_init(x0 if est_x0 is None else jnp.asarray(est_x0, jnp.float32),
                            0.1 * jnp.eye(4, dtype=jnp.float32), q, r)
    tick = make_scenario_step(
        cfg, step, costs.shaped4, fx, params, fx, hx, sig, MESH,
        backend="jnp", n_state=4, feed_true_state=true_state, n_substeps=substeps,
    )
    carry = init_scenario_carry(B, x0, jnp.zeros(8, jnp.float32), ukf0, jax.random.key(0))

    @jax.jit
    def chunk(c):
        def body(c, _):
            c = tick(c)
            return c, jnp.abs(c.x[:, 2])

        c, th = jax.lax.scan(body, c, jnp.arange(ticks))
        return c, th

    carry, th_hist = chunk(carry)
    th_hist = np.array(th_hist)
    alive = ~(th_hist > np.radians(60.0)).any(axis=0)
    surv = alive.mean()
    err = np.abs(np.array(carry.ukf.x) - np.array(carry.x))[alive]
    med_err = np.median(err, axis=0) if alive.any() else np.full(4, np.nan)
    print(
        f"{name:34s} survival={surv:6.3f}  median|th|={np.median(th_hist[-1][alive]) if alive.any() else float('nan'):.4f}  "
        f"med|x_est-x| alive={np.array2string(med_err, precision=3)}"
    )
    return surv


CFG_MPPI4 = MppiConfig(n_horizon=8, n_rollouts=K, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
CFG_S = MppiConfig(n_horizon=8, n_rollouts=K, lambda_=0.5, std_dev=10.0, limit=(-10.0, 10.0))

if __name__ == "__main__":
    print(f"B={B} K={K} ticks={TICKS} dt={DT}")
    q4 = noise.gen_q4(DT / 10)
    import functools
    mk = lambda k, **kw: MppiConfig(n_horizon=8, n_rollouts=k, lambda_=kw.get("lam", 0.5), std_dev=kw.get("std", 10.0), limit=(-10.0, 10.0))
    q4f = noise.gen_q4(0.05 / 5)
    run("O s-cfg K=1024 sub=10", q4, R_VAR, SIG_REF, mk(1024), substeps=10)
    run("P s-cfg K=1024 true", q4, R_VAR, SIG_REF, mk(1024), substeps=10, true_state=True)
    run("Q 20Hz K=1024 sub=5", q4f, R_VAR, SIG_REF, mk(1024), substeps=5, dt=0.05, ticks=100)
    run("R 20Hz K=1024 true", q4f, R_VAR, SIG_REF, mk(1024), substeps=5, dt=0.05, ticks=100, true_state=True)
    run("S 20Hz K=1024 std=5", q4f, R_VAR, SIG_REF, mk(1024, std=5.0), substeps=5, dt=0.05, ticks=100)
