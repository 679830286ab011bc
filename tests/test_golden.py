"""Golden-trajectory regression tests: fixed seeds → pinned trajectories.

Fixtures generated by tests/make_golden.py (f64, CPU). A change that moves
these beyond tolerance is a behavior change and must be deliberate.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from mpc_rs_jax.controllers.mppi import MppiConfig, mppi_solve
from mpc_rs_jax.estimators.ukf import ukf_init, ukf_predict, ukf_update
from mpc_rs_jax.models import costs, dynamics, observation
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.utils import as_vector_fn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def test_golden_mppi4_non_liner():
    ref = np.load(os.path.join(GOLDEN, "mppi4_non_liner.npz"))
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
    np.testing.assert_allclose(np.array(us), ref["u"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.array(xs), ref["x"], rtol=1e-9, atol=1e-9)


def test_golden_ukf_cartpole():
    ref = np.load(os.path.join(GOLDEN, "ukf_cartpole.npz"))
    p = CartPoleParams.single_wheel()
    fx = as_vector_fn(dynamics.make_cartpole_nonlinear(p, 0.01), 4)
    hx = observation.make_hx_rpm_gyro4(p)
    q = jnp.diag(jnp.asarray([0.0, 0.0, 0.0, 0.25]))
    r = jnp.diag(jnp.asarray([100.0, 100.0, 0.5]))
    params, state = ukf_init(jnp.zeros(4), 10.0 * jnp.eye(4), q, r)
    rng = np.random.default_rng(99)
    x_act = np.zeros(4)
    xs = []
    for i in range(50):
        x_act = np.array(fx(jnp.asarray(x_act), 0.1))
        z = np.array(hx(jnp.asarray(x_act))) + rng.normal(size=3) * [100, 100, 0.5]
        state = ukf_predict(params, state, 0.1, fx)
        state = ukf_update(params, state, jnp.asarray(z), hx)
        xs.append(np.array(state.x))
    np.testing.assert_allclose(np.array(xs), ref["x"], rtol=1e-8, atol=1e-8)


def test_golden_qp_mpc():
    from mpc_rs_jax.controllers.panoc import PanocConfig, box_projection, panoc_solve
    from mpc_rs_jax.controllers.qp import build_condensed_qp, make_qp_value_and_grad
    from mpc_rs_jax.models import reference

    ref = np.load(os.path.join(GOLDEN, "qp_mpc.npz"))
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
    np.testing.assert_allclose(np.array(us), ref["u"], rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(np.array(xs), ref["x"], rtol=1e-7, atol=1e-8)


def test_golden_flagship_multirate_both_modes():
    """The flagship multirate closed loop (scheduling + stack) reproduces
    the pinned trajectory exactly for both controller-input modes."""
    import contextlib
    import io

    from mpc_rs_jax.apps.mppi_examples import mppi4_non_liner_ukf
    from mpc_rs_jax.apps.run import build_parser

    for tag, extra in (("debug", []), ("est", ["--use-ukf-estimate"])):
        ref = np.load(os.path.join(GOLDEN, f"flagship_multirate_{tag}.npz"))
        args = build_parser().parse_args(
            ["mppi4-non-liner-ukf", "--k", "4096", "--seed", "7", "--t-end", "2.0",
             "--log-dir", "/tmp/golden-flagship-test"] + extra
        )
        with contextlib.redirect_stdout(io.StringIO()):
            res = mppi4_non_liner_ukf(args)
        assert bool(ref["tipped"]) == res.tipped
        np.testing.assert_allclose(res.t, float(ref["t_final"]), atol=1e-9)
        np.testing.assert_allclose(np.asarray(res.x), ref["x_final"], rtol=1e-6, atol=1e-9)
        hist = np.array(res.history)[:, 1][::50]
        np.testing.assert_allclose(hist, ref["u_hist"], rtol=1e-5, atol=1e-6)


def test_golden_commu_packet_chain():
    """Byte-fixed Sensor3 frames through COBS→parse→gen_q/gen_r→masked
    UKF reproduce the pinned estimates (the HW twin's math path)."""
    from mpc_rs_jax.estimators.ukf import ukf_init, ukf_predict, ukf_update
    from mpc_rs_jax.io.packets import Sensor3
    from mpc_rs_jax.models import dynamics, noise as noise_mod, observation
    from mpc_rs_jax.models.params import CartPoleParams

    ref = np.load(os.path.join(GOLDEN, "commu_packet_chain.npz"))
    frames = ref["frames"].tobytes()
    size = Sensor3.buf_size()
    p = CartPoleParams.two_wheel()
    plant6 = dynamics.make_accel6(p, with_force=False, quirk_denominator=True)
    hx = observation.make_hx_imu6(p)
    r_diag = jnp.asarray([200.0, 200.0, 20.0, 0.5, 0.5])
    phy = (50.0, 50.0, 10.0)
    params, est = ukf_init(
        jnp.zeros(6), 10.0 * jnp.eye(6), noise_mod.gen_q6(jnp.float64(0.06), phy=phy),
        jnp.diag(r_diag),
    )
    dt_est = 0.01
    ests = []
    for i in range(len(frames) // size):
        pkt = Sensor3.from_cobs(frames[i * size:(i + 1) * size])
        en, z = pkt.parse()
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
    np.testing.assert_allclose(np.array(ests), ref["est"], rtol=1e-7, atol=1e-9)


def test_golden_pallas_external_noise_trajectory():
    """Closed loop through the fused kernel tier under a fixed noise tensor
    matches the pinned trajectory (kernel layout/LSE/finalize regression)."""
    from mpc_rs_jax.controllers.mppi import MppiConfig
    from mpc_rs_jax.models import costs, dynamics
    from mpc_rs_jax.models.params import CartPoleParams
    from mpc_rs_jax.ops.mppi_pallas import mppi_solve_pallas

    ref = np.load(os.path.join(GOLDEN, "pallas_external_noise.npz"))
    p = CartPoleParams.single_wheel()
    dt = 0.8 / 8
    cfg = MppiConfig(n_horizon=8, n_rollouts=1024, lambda_=0.5, std_dev=3.0,
                     limit=(-20.0, 20.0))
    step = dynamics.make_cartpole_nonlinear(p, dt)
    bs = 8
    rng = np.random.default_rng(555)
    x = jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32)
    u_n = jnp.zeros(8, jnp.float32)
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
        np.testing.assert_allclose(np.asarray(x, np.float64), ref["x"][i], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(u_n[0]), ref["u"][i], rtol=1e-5, atol=1e-6)


def test_golden_box_qp_newton_both_paths():
    """Projected-Newton box-QP closed loop vs the pinned fixture — BOTH
    solve paths (masked unrolled Cholesky; active-set inverse table) must
    reproduce it. A drift here is a solver behavior change."""
    from mpc_rs_jax.controllers.qp import (
        active_set_inverse_table,
        box_qp_newton,
        build_condensed_qp,
        qp_linear_term,
    )
    from mpc_rs_jax.models import reference

    ref = np.load(os.path.join(GOLDEN, "box_qp_newton.npz"))
    p = CartPoleParams.single_wheel()
    dt = 0.8 / 8
    n = 8
    a, b = dynamics.linear_ab(p, dt)
    qp = build_condensed_qp(a, b, np.diag([5.0, 5.0, 1.0, 1.0]), n)
    gen_ref = reference.make_gen_ref_raised_cosine(n)
    aj, bj = jnp.asarray(a), jnp.asarray(b).reshape(-1)
    tbl = active_set_inverse_table(qp.h)
    for inv_table in (None, tbl):
        x = jnp.asarray([0.5, 0.0, 0.1, 0.0])
        u = jnp.zeros(n)
        xs, us = [], []
        for i in range(30):
            bq = qp_linear_term(qp, x, gen_ref(x).reshape(-1))
            u = box_qp_newton(qp.h, bq, u, -30.0, 30.0, iters=12, inv_table=inv_table)
            x = aj @ x + bj * u[0]
            xs.append(np.array(x))
            us.append(float(u[0]))
        np.testing.assert_allclose(np.array(xs), ref["x"], atol=1e-9)
        np.testing.assert_allclose(np.array(us), ref["u"], atol=1e-9)
