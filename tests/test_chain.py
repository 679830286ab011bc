"""Receding-horizon chain (a lax.scan of kernel solves) tests.

Interpret mode on CPU. The kernel's generator has a plain twin, so the
chain's values are checked against sequential solves on the same seeds."""

import jax.numpy as jnp
import numpy as np
import pytest

from mpc_rs_jax.controllers.mppi import MppiConfig
from mpc_rs_jax.models import costs, dynamics
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.ops.mppi_pallas import mppi_pallas_chain, mppi_solve_pallas


@pytest.fixture(scope="module")
def setup():
    p = CartPoleParams.single_wheel()
    step = dynamics.make_cartpole_nonlinear(p, 0.1)
    cfg = MppiConfig(n_horizon=8, n_rollouts=512, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    x0 = jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32)
    u0 = jnp.zeros(8, jnp.float32)
    return cfg, step, x0, u0


def test_chain_shapes_and_status(setup):
    cfg, step, x0, u0 = setup
    seeds = jnp.arange(5, dtype=jnp.int32)
    u0s, sts, un = mppi_pallas_chain(
        cfg, step, costs.shaped4, 4, seeds, x0, u0, interpret=True
    )
    assert u0s.shape == (5,) and sts.shape == (5,) and un.shape == (8,)
    assert (np.asarray(sts) == 0).all()
    assert np.isfinite(np.asarray(u0s)).all()


def test_chain_scalar_seed_mode(setup):
    cfg, step, x0, u0 = setup
    u0s, sts, un = mppi_pallas_chain(
        cfg, step, costs.shaped4, 4, None, x0, u0, interpret=True,
        n_solves=6, base_seed=99,
    )
    assert u0s.shape == (6,) and sts.shape == (6,)
    assert (np.asarray(sts) == 0).all()
    assert len(set(np.asarray(u0s).round(6))) > 1  # each solve has its own stream


def test_chain_pad_to_tile(setup):
    """A chain's prefix does not depend on its length: J=3 and J=8 chains
    with the same first 3 seeds share the warm-start prefix."""
    cfg, step, x0, u0 = setup
    u0s3, sts3, un3 = mppi_pallas_chain(
        cfg, step, costs.shaped4, 4, jnp.arange(3, dtype=jnp.int32), x0, u0, interpret=True
    )
    assert u0s3.shape == (3,)
    u0s8, _, _ = mppi_pallas_chain(
        cfg, step, costs.shaped4, 4, jnp.arange(8, dtype=jnp.int32), x0, u0, interpret=True
    )
    np.testing.assert_allclose(np.asarray(u0s3), np.asarray(u0s8[:3]), rtol=1e-6)


def test_chain_all_inf_cost_gives_no_finite(setup):
    cfg, step, x0, u0 = setup
    bad_cost = lambda *xs: jnp.full_like(xs[0], jnp.inf)
    u0s, sts, un = mppi_pallas_chain(
        cfg, step, bad_cost, 4, jnp.arange(4, dtype=jnp.int32), x0, u0, interpret=True
    )
    assert (np.asarray(sts) == 1).all()  # NO_FINITE
    np.testing.assert_array_equal(np.asarray(u0s), 0.0)  # zero fallback
    np.testing.assert_array_equal(np.asarray(un), 0.0)


def test_chain_plant_mode_runs(setup):
    """Closed-loop mode (plant=step) returns OK statuses and finite output."""
    cfg, step, x0, u0 = setup
    seeds = jnp.arange(8, dtype=jnp.int32)
    u0s_loop, sts, un = mppi_pallas_chain(
        cfg, step, costs.shaped4, 4, seeds, x0, u0, interpret=True, plant=step
    )
    assert (np.asarray(sts) == 0).all()
    assert np.isfinite(np.asarray(u0s_loop)).all() and np.isfinite(np.asarray(un)).all()


@pytest.mark.parametrize("plant", [False, True])
def test_chain_matches_sequential_solves(setup, plant):
    """The chain is the warm-started loop of single solves, value for
    value — with the state held, or advanced by the plant each solve."""
    cfg, step, x0, u0 = setup
    seeds = jnp.arange(4, dtype=jnp.int32) + 20
    u0s, sts, un = mppi_pallas_chain(cfg, step, costs.shaped4, 4, seeds, x0, u0,
                                     interpret=True, plant=step if plant else None)
    x, u = x0, u0
    for j in range(4):
        u, st = mppi_solve_pallas(cfg, step, costs.shaped4, 4, seeds[j], x, u, interpret=True)
        assert int(st) == int(sts[j])
        # f32: the chain's jitted plant step may contract a multiply-add
        # that this eager loop rounds twice
        np.testing.assert_allclose(float(u[0]), float(u0s[j]), rtol=1e-4, atol=1e-4)
        if plant:
            x = jnp.stack(step(*(x[c] for c in range(4)), u[0]))
    np.testing.assert_allclose(np.asarray(u), np.asarray(un), rtol=1e-4, atol=1e-4)
