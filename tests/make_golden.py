"""Regenerate golden-trajectory fixtures (run manually; outputs committed).

Golden trajectories pin the engine's exact closed-loop behavior under fixed
seeds — the regression mechanism the reference lacks entirely (its sampling
is entropy-seeded, SURVEY §4). f64 on CPU for platform stability.

  python tests/make_golden.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_ENABLE_X64", "1")
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from mpc_rs_jax.controllers.mppi import MppiConfig, mppi_solve
from mpc_rs_jax.estimators.ukf import ukf_init, ukf_predict, ukf_update
from mpc_rs_jax.models import costs, dynamics, observation
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.utils import as_vector_fn

OUT = os.path.join(os.path.dirname(__file__), "golden")


def golden_mppi4_non_liner():
    p = CartPoleParams.single_wheel()
    dt = 0.8 / 8
    cfg = MppiConfig(n_horizon=8, n_rollouts=8192, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    step = dynamics.make_cartpole_nonlinear(p, dt)
    solve = jax.jit(lambda k, x, u: mppi_solve(cfg, step, costs.shaped4, k, x, u))
    x = tuple(jnp.float64(v) for v in (0.5, 0.0, 0.1, 0.0))
    u_n = jnp.zeros(8)
    key = jax.random.key(1234)
    xs, us = [], []
    for i in range(40):
        key, sub = jax.random.split(key)
        res = solve(sub, x, u_n)
        u_n = res.u_n
        x = step(*x, u_n[0])
        xs.append([float(v) for v in x])
        us.append(float(u_n[0]))
    np.savez(os.path.join(OUT, "mppi4_non_liner.npz"), x=np.array(xs), u=np.array(us))


def golden_ukf_cartpole():
    p = CartPoleParams.single_wheel()
    fx = as_vector_fn(dynamics.make_cartpole_nonlinear(p, 0.01), 4)
    hx = observation.make_hx_rpm_gyro4(p)
    q = jnp.diag(jnp.asarray([0.0, 0.0, 0.0, 0.25]))
    r = jnp.diag(jnp.asarray([100.0, 100.0, 0.5]))
    params, state = ukf_init(jnp.zeros(4), 10.0 * jnp.eye(4), q, r)
    rng = np.random.default_rng(99)
    x_act = np.zeros(4)
    xs, ps = [], []
    for i in range(50):
        x_act = np.array(fx(jnp.asarray(x_act), 0.1))
        z = np.array(hx(jnp.asarray(x_act))) + rng.normal(size=3) * [100, 100, 0.5]
        state = ukf_predict(params, state, 0.1, fx)
        state = ukf_update(params, state, jnp.asarray(z), hx)
        xs.append(np.array(state.x))
        ps.append(np.diag(np.array(state.p)))
    np.savez(os.path.join(OUT, "ukf_cartpole.npz"), x=np.array(xs), p_diag=np.array(ps))


def golden_qp_mpc():
    from mpc_rs_jax.controllers.panoc import PanocConfig, box_projection, panoc_solve
    from mpc_rs_jax.controllers.qp import build_condensed_qp, make_qp_value_and_grad
    from mpc_rs_jax.models import reference

    p = CartPoleParams.single_wheel()
    dt = 0.8 / 8
    n = 8
    a, b = dynamics.linear_ab(p, dt)
    qp = build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), n)
    vgf = make_qp_value_and_grad(qp, reference.make_gen_ref_raised_cosine(n))
    cfg = PanocConfig(tol=1e-8, max_iter=200, lbfgs_mem=20)
    proj = box_projection(-30.0, 30.0)
    aj, bj = jnp.asarray(a), jnp.asarray(b).reshape(-1)
    x = jnp.asarray([0.5, 0.0, 0.1, 0.0])
    u = jnp.zeros(n)
    xs, us = [], []
    for i in range(30):
        res = panoc_solve(cfg, None, proj, u, value_and_grad=vgf(x))
        u = res.u
        x = aj @ x + bj * u[0]
        xs.append(np.array(x))
        us.append(float(u[0]))
    np.savez(os.path.join(OUT, "qp_mpc.npz"), x=np.array(xs), u=np.array(us))


def golden_box_qp_newton():
    """Closed loop with the batched projected-Newton box-QP solver (f64,
    both solve paths produce identical iterates — pinned via the masked-
    Cholesky path; test checks the inverse-table path against the same
    fixture)."""
    from mpc_rs_jax.controllers.qp import (
        box_qp_newton,
        build_condensed_qp,
        qp_linear_term,
    )
    from mpc_rs_jax.models import reference

    p = CartPoleParams.single_wheel()
    dt = 0.8 / 8
    n = 8
    a, b = dynamics.linear_ab(p, dt)
    qp = build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), n)
    gen_ref = reference.make_gen_ref_raised_cosine(n)
    aj, bj = jnp.asarray(a), jnp.asarray(b).reshape(-1)
    x = jnp.asarray([0.5, 0.0, 0.1, 0.0])
    u = jnp.zeros(n)
    xs, us = [], []
    for i in range(30):
        bq = qp_linear_term(qp, x, gen_ref(x).reshape(-1))
        u = box_qp_newton(qp.h, bq, u, -30.0, 30.0, iters=12)
        x = aj @ x + bj * u[0]
        xs.append(np.array(x))
        us.append(float(u[0]))
    np.savez(os.path.join(OUT, "box_qp_newton.npz"), x=np.array(xs), u=np.array(us))


def golden_flagship_multirate():
    """Flagship closed multirate loop, fixed seed, BOTH controller-input
    modes (DEBUG_UKF true-state default and --use-ukf-estimate) — pins
    runtime/loop.py scheduling + the whole flagship stack end-to-end
    (VERDICT round-1 Weak #5: a loop-scheduling regression must fail CI)."""
    from mpc_rs_jax.apps.mppi_examples import mppi4_non_liner_ukf
    from mpc_rs_jax.apps.run import build_parser

    import contextlib
    import io

    for tag, extra in (("debug", []), ("est", ["--use-ukf-estimate"])):
        args = build_parser().parse_args(
            ["mppi4-non-liner-ukf", "--k", "4096", "--seed", "7", "--t-end", "2.0",
             "--log-dir", "/tmp/golden-flagship"] + extra
        )
        with contextlib.redirect_stdout(io.StringIO()):
            res = mppi4_non_liner_ukf(args)
        hist = np.array(res.history)  # (ticks, 2): t, applied u
        np.savez(
            os.path.join(OUT, f"flagship_multirate_{tag}.npz"),
            t_final=res.t, tipped=res.tipped, x_final=np.asarray(res.x),
            u_hist=hist[:, 1][::50],  # every 50th physics tick
        )


def golden_commu_packet_chain():
    """Byte-fixed Sensor3 packet sequence through the full commu math chain:
    COBS decode → enable-mask parse → gen_r/gen_q → masked-hx UKF →
    6→4 state slice. Pins the HW twin's computational path without
    wall-clock nondeterminism (the PTY transport is covered by test_io)."""
    from mpc_rs_jax.io.packets import Sensor3
    from mpc_rs_jax.models import noise as noise_mod

    p = CartPoleParams.two_wheel()
    # mppi4-ukf-commu's own fx, incl. its cos(ẍ) denominator quirk (:139)
    plant6 = dynamics.make_accel6(p, with_force=False, quirk_denominator=True)
    hx = observation.make_hx_imu6(p)
    r_diag = jnp.asarray([200.0, 200.0, 20.0, 0.5, 0.5])
    phy = (50.0, 50.0, 10.0)
    params, est = ukf_init(
        jnp.zeros(6), 10.0 * jnp.eye(6), noise_mod.gen_q6(jnp.float64(0.06), phy=phy),
        jnp.diag(r_diag),
    )
    rng = np.random.default_rng(2024)
    frames = []
    ests = []
    dt_est = 0.01
    for i in range(20):
        enable = 0b11111 if i % 5 else 0b00111  # periodic accel dropout
        pkt = Sensor3(
            enable=enable,
            encoder0=int(rng.integers(-500, 500)),
            encoder1=int(rng.integers(-500, 500)),
            gyro=float(rng.normal() * 5.0),
            accel0=float(rng.normal() * 0.3),
            accel1=float(1.0 + rng.normal() * 0.3),
        )
        wire = pkt.as_cobs()
        frames.append(np.frombuffer(wire, dtype=np.uint8))
        rt = Sensor3.from_cobs(wire)
        en, z = rt.parse()
        mask = noise_mod.enable_bits_to_mask(en)

        def fxd(xv, uu):
            out = plant6(*(xv[..., j] for j in range(6)), uu, dt_est, 0.0)
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

        est = est._replace(
            q=noise_mod.gen_q6(jnp.float64(dt_est), phy=phy).astype(est.q.dtype),
            r=noise_mod.gen_r_mask(r_diag, mask).astype(est.r.dtype),
        )
        est = ukf_predict(params, est, 0.5, fxd)
        est = ukf_update(params, est, jnp.asarray(z), observation.make_masked_hx(hx, mask))
        ests.append(np.asarray(est.x))
    np.savez(
        os.path.join(OUT, "commu_packet_chain.npz"),
        frames=np.concatenate(frames), est=np.array(ests),
    )


def golden_pallas_external_noise():
    """Closed loop through the FUSED KERNEL tier (interpret mode) under a
    fixed external noise tensor — pins the kernel's rollout, log-sum-exp
    merge and finalize end-to-end."""
    from mpc_rs_jax.ops.mppi_pallas import mppi_solve_pallas

    p = CartPoleParams.single_wheel()
    dt = 0.8 / 8
    cfg = MppiConfig(n_horizon=8, n_rollouts=1024, lambda_=0.5, std_dev=3.0,
                     limit=(-20.0, 20.0))
    step = dynamics.make_cartpole_nonlinear(p, dt)
    bs = 8
    rng = np.random.default_rng(555)
    x = jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32)
    u_n = jnp.zeros(8, jnp.float32)
    xs, us = [], []
    for i in range(10):
        eps = (3.0 * rng.standard_normal((1, 8, bs, 128))).astype(np.float32)
        # the fixture's (block, step, sublane, lane) draw order, as (K, N)
        # rows: rollout = sublane·128 + lane
        eps_kn = eps.transpose(0, 2, 3, 1).reshape(1024, 8)
        u_n, st = mppi_solve_pallas(
            cfg, step, costs.shaped4, 4, 0, x, u_n, interpret=True, noise=jnp.asarray(eps_kn),
        )
        assert int(st) == 0
        x = jnp.stack(step(*(x[j] for j in range(4)), u_n[0]))
        xs.append(np.asarray(x, np.float64))
        us.append(float(u_n[0]))
    np.savez(os.path.join(OUT, "pallas_external_noise.npz"), x=np.array(xs), u=np.array(us))


if __name__ == "__main__":
    os.makedirs(OUT, exist_ok=True)
    golden_mppi4_non_liner()
    golden_ukf_cartpole()
    golden_qp_mpc()
    golden_box_qp_newton()
    golden_flagship_multirate()
    golden_commu_packet_chain()
    golden_pallas_external_noise()
    print("golden fixtures written to", OUT)
