"""Diagnose flagship6 fleet survival (VERDICT round-1 Weak #2, target ≥0.95).

Reference operating point (mppi4-non-liner-ukf.rs): x0 = 0, 2 N push during
t∈(1,1.5) s, sensor σ = [200,200,10,0.05,0.05] every ~9 ms, UKF2(6,5) with
set_q(gen_q(dt)), MPPI T=1.2 N=8 λ=1.4 σ=4 limit ±10, tip-over |θ|>π/2.

Usage: python scripts/diag_flagship.py [B] [K] [TICKS]
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

B = int(sys.argv[1]) if len(sys.argv) > 1 else 128
K = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
TICKS = int(sys.argv[3]) if len(sys.argv) > 3 else 150

p = CartPoleParams.two_wheel()
plant6 = dynamics.make_flagship6(p)
hx = observation.make_hx_imu6(p)
MESH = make_mesh({"scenario": 1, "rollouts": 1}, devices=jax.devices()[:1])
SIG_REF = jnp.asarray([200.0, 200.0, 10.0, 0.05, 0.05], jnp.float32)


def run(name, *, sig=SIG_REF, r=None, dt=0.02, substeps=2, true_state=False,
        k=K, ticks=TICKS, std=4.0, q_dt=None, pulse=2.0, p0=10.0, cs=0.0,
        sqrt_method="eigh"):
    dt_sub = dt / substeps

    def plant_fx(xv, u, f):
        out = plant6(*(xv[..., i] for i in range(6)), u, dt_sub, f)
        return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

    def ukf_fx(xv, u):
        out = plant6(*(xv[..., i] for i in range(6)), u, dt_sub, 0.0)
        return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

    r = jnp.diag(sig * sig) if r is None else r
    params, ukf0 = ukf_init(
        jnp.zeros(6, jnp.float32), p0 * jnp.eye(6, dtype=jnp.float32),
        noise.gen_q6(jnp.float32(q_dt if q_dt else dt_sub)).astype(jnp.float32), r,
        sqrt_method=sqrt_method,
    )
    cfg = MppiConfig(n_horizon=8, n_rollouts=k, lambda_=1.4, std_dev=std, limit=(-10.0, 10.0))
    ctrl_step = dynamics.make_flagship4(p, 1.2 / 8)
    tick = make_scenario_step(
        cfg, ctrl_step, costs.make_diag4(0.1, 0.1, 1.0, 0.5), plant_fx, params,
        ukf_fx, hx, sig, MESH, backend="jnp", n_state=4, state_slice=(0, 1, 3, 4),
        feed_true_state=true_state, n_substeps=substeps, dt_tick=dt, control_start=cs,
        disturbance=lambda t: jnp.where((t > 1.0) & (t < 1.5), jnp.float32(pulse), jnp.float32(0.0)),
    )
    carry = init_scenario_carry(B, jnp.zeros(6, jnp.float32), jnp.zeros(8, jnp.float32),
                                ukf0, jax.random.key(0))

    @jax.jit
    def chunk(c):
        def body(c, _):
            c = tick(c)
            return c, jnp.abs(c.x[:, 3])

        return jax.lax.scan(body, c, jnp.arange(ticks))

    carry, th_hist = chunk(carry)
    th_hist = np.array(th_hist)
    tipped = th_hist > np.pi / 2
    alive = ~tipped.any(axis=0)
    surv = alive.mean()
    if not alive.all():
        first = np.where(tipped.any(axis=0), tipped.argmax(axis=0), -1)
        tip_times = np.sort(first[first >= 0]) * dt
        print(f"   tip times: {np.array2string(tip_times[:12], precision=2)}")
    err = np.abs(np.array(carry.ukf.x) - np.array(carry.x))[alive]
    med_err = np.median(err, axis=0) if alive.any() else np.full(6, np.nan)
    th_end = th_hist[-1][alive]
    print(
        f"{name:34s} survival={surv:6.3f}  median|th|={np.median(th_end) if alive.any() else float('nan'):.4f}  "
        f"med_err={np.array2string(med_err, precision=3)}"
    )
    return surv


if __name__ == "__main__":
    print(f"B={B} K={K} ticks={TICKS}")
    kw = dict(r=jnp.diag(SIG_REF), q_dt=0.0215, dt=0.01, substeps=1)
    if len(sys.argv) > 4 and sys.argv[4] == "sqrt":
        # matched-seed sigma-root comparison (STATUS gap #2: recover the
        # eigh throughput with the unrolled Jacobi eigen-root)
        for m in ("eigh", "jacobi", "cholesky"):
            run(f"K{K} P0=.1 sqrt={m}", k=K, p0=0.1, ticks=TICKS,
                sqrt_method=m, **kw)
    else:
        run("K8192 P0=.1 5s", k=8192, p0=0.1, ticks=TICKS, **kw)
