"""Property/fuzz tests over the model zoo.

Random states/params through every dynamics factory:
- tuple-style and vector-style (as_vector_fn) paths agree exactly,
- f32 tracks f64 within single-precision tolerance,
- outputs are finite on bounded inputs,
- broadcasting over batch shapes matches per-sample evaluation.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mpc_rs_jax.models import dynamics
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.utils import as_vector_fn

P4 = [
    ("linear", lambda p: dynamics.make_cartpole_linear(p, 0.05), CartPoleParams.single_wheel()),
    ("nonlinear", lambda p: dynamics.make_cartpole_nonlinear(p, 0.05), CartPoleParams.single_wheel()),
    ("flagship4", lambda p: dynamics.make_flagship4(p, 0.05), CartPoleParams.two_wheel()),
    ("commu4", lambda p: dynamics.make_commu4(p, 0.05), CartPoleParams.two_wheel()),
    ("pid-quirk", lambda p: dynamics.make_cartpole_linear_pid(p, 0.05), CartPoleParams.single_wheel()),
]

P6 = [
    ("pen6", lambda p: dynamics.make_pen6(p, 0.05), CartPoleParams.single_wheel()),
]


@pytest.mark.parametrize("name,factory,params", P4)
def test_vector_adapter_matches_tuple_4state(name, factory, params):
    step = factory(params)
    fvec = as_vector_fn(step, 4)
    rng = np.random.default_rng(hash(name) % 2**31)
    for _ in range(25):
        x = rng.uniform(-1.5, 1.5, size=4)
        u = float(rng.uniform(-20, 20))
        a = np.array([float(v) for v in step(*(jnp.float64(c) for c in x), u)])
        b = np.array(fvec(jnp.asarray(x), u))
        np.testing.assert_allclose(a, b, rtol=1e-12)
        assert np.isfinite(a).all()


@pytest.mark.parametrize("name,factory,params", P4)
def test_f32_tracks_f64_4state(name, factory, params):
    step = factory(params)
    fvec = as_vector_fn(step, 4)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.0, 1.0, size=(64, 4))
    u = rng.uniform(-10, 10, size=64)
    out64 = np.array(fvec(jnp.asarray(x), jnp.asarray(u)))
    out32 = np.array(fvec(jnp.asarray(x, jnp.float32), jnp.asarray(u, jnp.float32)))
    np.testing.assert_allclose(out32, out64, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("name,factory,params", P4)
def test_batch_broadcast_matches_loop_4state(name, factory, params):
    step = factory(params)
    fvec = as_vector_fn(step, 4)
    rng = np.random.default_rng(2)
    xs = rng.uniform(-1, 1, size=(8, 4))
    us = rng.uniform(-5, 5, size=8)
    batched = np.array(fvec(jnp.asarray(xs), jnp.asarray(us)))
    for i in range(8):
        one = np.array(fvec(jnp.asarray(xs[i]), float(us[i])))
        np.testing.assert_allclose(batched[i], one, rtol=1e-12)


@pytest.mark.parametrize("name,factory,params", P6)
def test_vector_adapter_matches_tuple_6state(name, factory, params):
    step = factory(params)
    fvec = as_vector_fn(step, 6)
    rng = np.random.default_rng(3)
    for _ in range(10):
        x = rng.uniform(-1, 1, size=6)
        u = float(rng.uniform(-10, 10))
        a = np.array([float(v) for v in step(*(jnp.float64(c) for c in x), u)])
        b = np.array(fvec(jnp.asarray(x), u))
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_flagship6_accel6_force_consistency():
    """With f=0 and dt→0 the two 6-state formulations' accelerations agree
    on matched sub-states (they share the same physical ddot core)."""
    p = CartPoleParams.two_wheel()
    f6 = dynamics.make_flagship6(p)
    a6 = dynamics.make_accel6(p, with_force=True)
    rng = np.random.default_rng(4)
    for _ in range(10):
        x = rng.uniform(-0.5, 0.5, size=6)
        u = float(rng.uniform(-5, 5))
        out_f = np.array([float(v) for v in f6(*(jnp.float64(c) for c in x), u, 1e-9, 0.0)])
        out_a = np.array([float(v) for v in a6(*(jnp.float64(c) for c in x), u, 1e-9, 0.0)])
        # ddot_theta lands in slot 5 of both
        np.testing.assert_allclose(out_f[5], out_a[5], rtol=1e-9)
        # ddot_x: flagship stores it in slot 2 (as does accel6)
        np.testing.assert_allclose(out_f[2], out_a[2], rtol=1e-9)
