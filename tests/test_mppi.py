"""MPPI core: properties, statuses, closed-loop convergence, oracle parity."""

import jax
import jax.numpy as jnp
import numpy as np

from mpc_rs_jax.controllers.mppi import MppiConfig, MppiStatus, mppi_solve, rollout_scores
from mpc_rs_jax.models import costs, dynamics
from mpc_rs_jax.models.params import CartPoleParams


def _di_cfg(k=512):
    return MppiConfig(n_horizon=10, n_rollouts=k, lambda_=2.5, std_dev=1.0, limit=(-3.0, 3.0))


def test_deterministic_given_key():
    cfg = _di_cfg()
    step = dynamics.make_double_integrator(0.05)
    key = jax.random.key(0)
    r1 = mppi_solve(cfg, step, costs.quad2, key, (1.0, 0.0), jnp.zeros(10))
    r2 = mppi_solve(cfg, step, costs.quad2, key, (1.0, 0.0), jnp.zeros(10))
    np.testing.assert_array_equal(np.array(r1.u_n), np.array(r2.u_n))
    assert int(r1.status) == MppiStatus.OK


def test_output_within_limits():
    cfg = _di_cfg()
    step = dynamics.make_double_integrator(0.05)
    r = mppi_solve(cfg, step, costs.quad2, jax.random.key(1), (1.0, 0.0), jnp.zeros(10))
    u = np.array(r.u_n)
    assert (u >= cfg.limit[0] - 1e-12).all() and (u <= cfg.limit[1] + 1e-12).all()


def test_status_no_finite():
    cfg = _di_cfg(64)
    step = dynamics.make_double_integrator(0.05)
    bad_cost = lambda x0, x1: jnp.full_like(x0, jnp.inf)
    r = mppi_solve(cfg, step, bad_cost, jax.random.key(0), (1.0, 0.0), jnp.zeros(10))
    assert int(r.status) == MppiStatus.NO_FINITE
    np.testing.assert_array_equal(np.array(r.u_n), 0.0)


def test_status_nan_cost_is_filtered_but_ok():
    # one NaN rollout must not poison the softmax (mirrors the reference's
    # is_finite filter on the max, src/mppi.rs:66-68)
    cfg = _di_cfg(64)
    step = dynamics.make_double_integrator(0.05)

    def spiky_cost(x0, x1):
        # NaN whenever x0 drifts negative enough — some rollouts only
        return jnp.where(x0 < -0.5, jnp.nan, x0 * x0 + x1 * x1)

    r = mppi_solve(cfg, step, spiky_cost, jax.random.key(3), (-0.4, -0.3), jnp.zeros(10))
    assert int(r.status) == MppiStatus.OK
    assert np.isfinite(np.array(r.u_n)).all()


def test_closed_loop_double_integrator_converges():
    """mppi2.rs scenario: from x=[1,0] the controller regulates to ~0."""
    dt = 2.0 / 40
    cfg = MppiConfig(n_horizon=40, n_rollouts=2000, lambda_=2.5, std_dev=1.0, limit=(-3.0, 3.0))
    step = dynamics.make_double_integrator(dt)
    solve = jax.jit(lambda key, x, u: mppi_solve(cfg, step, costs.quad2, key, x, u))
    x = (jnp.float64(1.0), jnp.float64(0.0))
    u_n = jnp.zeros(40)
    key = jax.random.key(42)
    for i in range(100):
        key, sub = jax.random.split(key)
        res = solve(sub, x, u_n)
        u_n = res.u_n
        x = step(x[0], x[1], u_n[0])
    assert abs(float(x[0])) < 0.15
    assert abs(float(x[1])) < 0.3


def test_closed_loop_cartpole_nonlinear_survives():
    """mppi4-non-liner.rs config (scaled-down K): pendulum must not tip."""
    p = CartPoleParams.single_wheel()
    dt = 0.8 / 8
    cfg = MppiConfig(n_horizon=8, n_rollouts=4096, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    step = dynamics.make_cartpole_nonlinear(p, dt)
    solve = jax.jit(lambda key, x, u: mppi_solve(cfg, step, costs.shaped4, key, x, u))
    x = tuple(jnp.float64(v) for v in (0.5, 0.0, 0.1, 0.0))
    u_n = jnp.zeros(8)
    key = jax.random.key(7)
    for i in range(80):  # 8 sim-seconds
        key, sub = jax.random.split(key)
        res = solve(sub, x, u_n)
        assert int(res.status) == MppiStatus.OK
        u_n = res.u_n
        x = step(*x, u_n[0])
        assert abs(float(x[2])) < np.radians(60.0), f"tipped at step {i}"
    assert abs(float(x[2])) < 0.2


def test_rollout_scores_vs_numpy_oracle():
    """Score formula s = −Σcost − Σ u σ⁻² v vs a plain NumPy rollout."""
    p = CartPoleParams.single_wheel()
    dt = 0.1
    step = dynamics.make_cartpole_nonlinear(p, dt)
    rng = np.random.default_rng(0)
    v = rng.normal(size=(16, 8))
    u_n = rng.normal(size=(8,))
    x0 = np.array([0.5, 0.0, 0.1, 0.0])
    got = np.array(
        rollout_scores(step, costs.shaped4, tuple(jnp.float64(c) for c in x0), jnp.asarray(v), jnp.asarray(u_n), 3.0)
    )

    def np_step(x, u):
        return np.array([float(c) for c in step(*(jnp.float64(xx) for xx in x), float(u))])

    want = np.zeros(16)
    for k in range(16):
        x = x0.copy()
        c = 0.0
        for t in range(8):
            x = np_step(x, v[k, t])
            c += float(costs.shaped4(*x))
        want[k] = -c - np.sum(u_n * (3.0**-2) * v[k])
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_f32_scores_match_f64_on_same_samples():
    """f32 (the accelerator dtype) rollout scoring tracks the f64 oracle on identical
    sampled sequences — the dtype-parity requirement of SURVEY §7."""
    p = CartPoleParams.single_wheel()
    step64 = dynamics.make_cartpole_nonlinear(p, 0.1)
    v32 = 3.0 * jax.random.normal(jax.random.key(5), (256, 8), dtype=jnp.float32)
    v64 = v32.astype(jnp.float64)
    u = jnp.zeros(8)
    x64 = tuple(jnp.float64(c) for c in (0.5, 0.0, 0.1, 0.0))
    x32 = tuple(jnp.float32(c) for c in (0.5, 0.0, 0.1, 0.0))
    s64 = rollout_scores(step64, costs.shaped4, x64, v64, u, 3.0)
    s32 = rollout_scores(step64, costs.shaped4, x32, v32, u.astype(jnp.float32), 3.0)
    assert s32.dtype == jnp.float32
    np.testing.assert_allclose(np.array(s32), np.array(s64), rtol=2e-4, atol=1e-3)


def test_control_inv_override_mppi2_weighting():
    """control_inv reproduces mppi2's weighting: exp(−c/λ − Σ u/R·v)
    (examples/mppi2.rs:59-70, control term NOT divided by λ)."""
    step = dynamics.make_double_integrator(0.05)
    lam, r_sig = 2.5, 1.0
    cfg = MppiConfig(n_horizon=6, n_rollouts=128, lambda_=lam, std_dev=r_sig,
                     limit=(-3.0, 3.0), control_inv=lam / r_sig)
    key = jax.random.key(0)
    u_n = jnp.full((6,), 0.7)
    res = mppi_solve(cfg, step, costs.quad2, key, (1.0, 0.0), u_n)
    # oracle: same samples, mppi2 weighting
    eps = r_sig * jax.random.normal(key, (128, 6), dtype=u_n.dtype)
    v = np.clip(np.array(u_n + eps), -3.0, 3.0)
    s = np.array(rollout_scores(step, costs.quad2, (jnp.float64(1.0), jnp.float64(0.0)),
                                jnp.asarray(v), u_n, 1e9))  # control term ~0
    c = -s  # pure cost
    w = np.exp((-c / lam) - (v @ (np.array(u_n) / r_sig)))
    want = (w / w.sum()) @ v
    np.testing.assert_allclose(np.array(res.u_n), want, rtol=1e-6, atol=1e-9)
