"""Tolerance bounds for ops.fastmath and the fast-dynamics variants.

Exact-parity tests elsewhere keep fast=False; these pin the documented
error budget of the fast path (tolerance-tested fast transcendentals
behind a flag)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_rs_jax.ops import fastmath as fm


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(42)


def test_fsin_fcos_bounds(rng):
    x = jnp.asarray(rng.uniform(-100.0, 100.0, 200_000), jnp.float32)
    assert float(jnp.max(jnp.abs(fm.fsin(x) - jnp.sin(x)))) < 1e-5
    assert float(jnp.max(jnp.abs(fm.fcos(x) - jnp.cos(x)))) < 1e-5
    s, c = fm.fsincos(x)
    np.testing.assert_array_equal(np.asarray(s), np.asarray(fm.fsin(x)))
    np.testing.assert_array_equal(np.asarray(c), np.asarray(fm.fcos(x)))


def test_fsin_finite_for_huge_inputs():
    x = jnp.asarray([1e6, -1e6, 3.4e37, -3.4e37], jnp.float32)
    assert np.isfinite(np.asarray(fm.fsin(x))).all()
    assert np.isfinite(np.asarray(fm.fcos(x))).all()


def test_fast_dynamics_close_to_exact():
    from mpc_rs_jax.models import dynamics
    from mpc_rs_jax.models.params import CartPoleParams

    rng = np.random.default_rng(7)
    p = CartPoleParams.single_wheel()
    a = dynamics.make_cartpole_nonlinear(p, 0.1)
    b = dynamics.make_cartpole_nonlinear(p, 0.1, fast=True)
    xs = rng.uniform(-2.0, 2.0, (500, 4)).astype(np.float32)
    us = rng.uniform(-20.0, 20.0, 500).astype(np.float32)
    for x, u in zip(xs[:50], us[:50]):
        ra = np.asarray(a(*map(jnp.float32, x), jnp.float32(u)))
        rb = np.asarray(b(*map(jnp.float32, x), jnp.float32(u)))
        np.testing.assert_allclose(ra, rb, atol=5e-5)

    # flagship: 1/d with d near-singular amplifies the trig error; bound
    # relative instead
    p2 = CartPoleParams.two_wheel()
    a4 = dynamics.make_flagship4(p2, 0.15)
    b4 = dynamics.make_flagship4(p2, 0.15, fast=True)
    for x, u in zip(xs[:50], us[:50]):
        ra = np.asarray(a4(*map(jnp.float32, x), jnp.float32(u)))
        rb = np.asarray(b4(*map(jnp.float32, x), jnp.float32(u)))
        np.testing.assert_allclose(ra, rb, rtol=2e-4, atol=2e-4)


def test_fast_mppi_solution_close():
    """Same threefry noise through the vmap solver with exact vs fast
    dynamics: returned sequences agree to well under the sampling noise."""
    from mpc_rs_jax.controllers.mppi import MppiConfig, mppi_solve
    from mpc_rs_jax.models import costs, dynamics
    from mpc_rs_jax.models.params import CartPoleParams

    p = CartPoleParams.single_wheel()
    cfg = MppiConfig(n_horizon=8, n_rollouts=2048, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    key = jax.random.key(3)
    x = (jnp.float32(0.5), jnp.float32(0.0), jnp.float32(0.1), jnp.float32(0.0))
    u0 = jnp.zeros(8, jnp.float32)
    re = mppi_solve(cfg, dynamics.make_cartpole_nonlinear(p, 0.1), costs.shaped4, key, x, u0)
    rf = mppi_solve(cfg, dynamics.make_cartpole_nonlinear(p, 0.1, fast=True), costs.shaped4, key, x, u0)
    assert int(re.status) == 0 and int(rf.status) == 0
    np.testing.assert_allclose(np.asarray(re.u_n), np.asarray(rf.u_n), atol=2e-3)
