"""Scenario-parallel batched closed loops on a 2-D scenario×rollouts mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_rs_jax.controllers.mppi import MppiConfig
from mpc_rs_jax.estimators.ukf import ukf_init
from mpc_rs_jax.models import costs, dynamics, observation
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.parallel.mesh import make_mesh
from mpc_rs_jax.parallel.scenario import init_scenario_carry, make_scenario_step
from mpc_rs_jax.utils import as_vector_fn


def _build(mesh, batch, k_total):
    p = CartPoleParams.single_wheel()
    dt = 0.1
    # N=8 (T=0.8 s) as in mppi4-non-liner; a 4-step horizon is marginally
    # stable for this plant and flips with sampling luck
    cfg = MppiConfig(n_horizon=8, n_rollouts=k_total, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    step = dynamics.make_cartpole_nonlinear(p, dt)
    fx = as_vector_fn(step, 4)
    hx = observation.make_hx_rpm_gyro4(p)
    q = jnp.diag(jnp.asarray([0.0, 0.0, 0.0, 0.25], jnp.float32))
    # one observation per 0.1 s control tick (the reference observes at
    # ~100 Hz); noise scaled to this cadence for a stabilizable fleet
    r = jnp.diag(jnp.asarray([50.0, 50.0, 0.2], jnp.float32))
    # near-converged initial covariance: scenario fleets resume from
    # checkpoints, not cold estimator starts (P=10 I gives a transient where
    # the controller chases estimator noise for several ticks)
    params, ukf0 = ukf_init(
        jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32), 0.1 * jnp.eye(4, dtype=jnp.float32), q, r
    )
    tick = make_scenario_step(
        cfg, step, costs.shaped4, fx, params, fx, hx,
        jnp.asarray([50.0, 50.0, 0.2], jnp.float32), mesh,
    )
    carry = init_scenario_carry(
        batch,
        jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32),
        jnp.zeros(8, jnp.float32),
        ukf0,
        jax.random.key(0),
    )
    return tick, carry, step


def test_scenario_step_advances_all():
    mesh = make_mesh({"scenario": 2, "rollouts": 4})
    tick, carry, step = _build(mesh, batch=8, k_total=4 * 128)
    c1 = tick(carry)
    assert c1.x.shape == (8, 4)
    assert np.isfinite(np.array(c1.x)).all()
    assert (np.array(c1.status) == 0).all()
    # controls differ across scenarios (independent keys) ...
    assert len(np.unique(np.array(c1.u_n[:, 0]))) > 1
    # ... and every scenario actually moved
    assert (np.abs(np.array(c1.x) - np.array(carry.x)) > 0).any(axis=1).all()


def test_scenario_substeps_and_disturbance():
    """n_substeps advances the plant n times at the substep dt; the
    disturbance window pushes the plant exactly during t∈(t0,t1)."""
    p = CartPoleParams.two_wheel()
    plant6 = dynamics.make_flagship6(p)
    dt, n_sub = 0.02, 2
    dt_sub = dt / n_sub

    def plant_fx(xv, u, f):
        out = plant6(*(xv[..., i] for i in range(6)), u, dt_sub, f)
        return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

    def ukf_fx(xv, u):
        out = plant6(*(xv[..., i] for i in range(6)), u, dt_sub, 0.0)
        return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

    from mpc_rs_jax.models import noise as noise_mod

    hx = observation.make_hx_imu6(p)
    sens = jnp.asarray([200.0, 200.0, 10.0, 0.05, 0.05], jnp.float32)
    p0 = 0.1 * jnp.eye(6, dtype=jnp.float32)
    params, ukf0 = ukf_init(
        jnp.zeros(6, jnp.float32), p0,
        noise_mod.gen_q6(jnp.float32(dt_sub)).astype(jnp.float32), jnp.diag(sens),
    )
    cfg = MppiConfig(n_horizon=8, n_rollouts=64, lambda_=1.4, std_dev=4.0, limit=(-10.0, 10.0))
    mesh = make_mesh({"scenario": 1, "rollouts": 1}, devices=jax.devices()[:1])

    def build(pulse):
        return make_scenario_step(
            cfg, dynamics.make_flagship4(p, 0.15), costs.make_diag4(0.1, 0.1, 1.0, 0.5),
            plant_fx, params, ukf_fx, hx, sens, mesh,
            n_state=4, state_slice=(0, 1, 3, 4), n_substeps=n_sub, dt_tick=dt,
            ukf_p_reset=p0,
            disturbance=lambda t: jnp.where(
                (t >= 0.0) & (t < 0.02), jnp.float32(pulse), jnp.float32(0.0)
            ),
        )

    carry = init_scenario_carry(
        4, jnp.zeros(6, jnp.float32), jnp.zeros(8, jnp.float32), ukf0, jax.random.key(1)
    )
    # sim time advances by dt_tick per tick
    c_push = build(50.0)(carry)
    assert np.allclose(np.array(c_push.t), dt)
    c_free = build(0.0)(carry)
    # the window covers both substeps of tick 0 only: a 50 N push must move θ
    dth = np.abs(np.array(c_push.x[:, 3]) - np.array(c_free.x[:, 3]))
    assert (dth > 1e-4).all(), dth
    # ticks at t≥window see no force: same controls → identical increments
    c2_push, c2_free = build(50.0)(c_push), build(0.0)(c_push)
    np.testing.assert_allclose(np.array(c2_push.x), np.array(c2_free.x), rtol=1e-6)


def test_ukf_guard_recovers_nan():
    from mpc_rs_jax.estimators.ukf import UkfState, ukf_guard

    p0 = jnp.eye(3, dtype=jnp.float32)
    bad = UkfState(
        x=jnp.asarray([[1.0, jnp.nan, 2.0], [1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]),
        p=jnp.stack([jnp.eye(3) * 5.0, jnp.full((3, 3), jnp.nan), jnp.eye(3) * 7.0]),
        q=jnp.zeros((3, 3, 3)), r=jnp.zeros((3, 2, 2)), sigma_f=jnp.zeros((3, 7, 3)),
    )
    out = ukf_guard(bad, p0)
    np.testing.assert_allclose(
        np.array(out.x), [[1.0, 0.0, 2.0], [1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]
    )
    np.testing.assert_allclose(np.array(out.p[0]), np.eye(3))  # NaN mean → P reset too
    np.testing.assert_allclose(np.array(out.p[1]), np.eye(3))  # NaN P reset
    np.testing.assert_allclose(np.array(out.p[2]), np.eye(3) * 7.0)  # healthy: untouched


def test_fleet_build_both_models_one_tick():
    """build_fleet wires the validated round-2 operating points; one tick of
    each model runs finite on the jnp backend."""
    from mpc_rs_jax.apps.fleet import build_fleet

    mesh = make_mesh({"scenario": 1, "rollouts": 1}, devices=jax.devices()[:1])
    for model in ("cartpole4", "flagship6"):
        tick, carry, dt, th_idx, guard = build_fleet(model, 64, "vmap", mesh, scenarios=4)
        c1 = tick(carry)
        assert np.isfinite(np.array(c1.x)).all(), model
        assert np.isfinite(np.array(c1.ukf.x)).all(), model
        assert abs(float(c1.t[0]) - dt) < 1e-6


def test_scenario_loop_stabilizes_population():
    """20 ticks on 8 scenarios: median |theta| must shrink (closed-loop
    control works through the 2-D sharded path end-to-end)."""
    mesh = make_mesh({"scenario": 2, "rollouts": 4})
    tick, carry, step = _build(mesh, batch=8, k_total=4 * 512)
    for _ in range(20):
        carry = tick(carry)
    th_all = np.abs(np.array(carry.x[:, 2]))
    assert np.isfinite(np.array(carry.x)).all()
    # every scenario survives (no tip-over) and the pole angles stay bounded
    assert (th_all < np.radians(60.0)).all(), f"tipped: {th_all}"
    assert np.median(th_all) < 0.3


@pytest.mark.parametrize("solver", ["newton", "panoc"])
def test_qp_fleet_parks_population(solver):
    """Batched gradient-MPC fleet: every scenario parks within 3 s and
    stays upright — examples/op-mpc-x-calc-nl.rs batched. Both solvers
    (batched projected Newton, vmapped PANOC) must close the loop."""
    from mpc_rs_jax.apps.fleet import build_qp_fleet

    tick, carry, dt = build_qp_fleet(16, seed=1, max_iter=60, solver=solver)
    for _ in range(int(3.0 / dt)):
        carry = tick(carry)
    x = np.array(carry[0])
    assert np.isfinite(x).all()
    assert (np.abs(x[:, 2]) < np.pi / 2).all()
    assert np.median(np.abs(x[:, 0])) < 0.3


def test_qp_fleet_shards_over_scenario_mesh():
    """The QP fleet is pure scenario-DP: placing the carry on an 8-device
    'scenario' mesh partitions every tick op automatically (batch-elementwise
    Newton iterations + shared (N,N) constants — no collectives needed).
    One tick matches the single-device result to f32 tolerance; the closed
    loop still parks the population (reduction-order drift compounds through
    the chaotic plant, so multi-tick states are compared behaviorally)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mpc_rs_jax.apps.fleet import build_qp_fleet
    from mpc_rs_jax.parallel.mesh import make_mesh

    mesh = make_mesh({"scenario": 8})
    tick, carry, dt = build_qp_fleet(64, seed=3)
    sh = NamedSharding(mesh, P("scenario"))
    carry_sh = (jax.device_put(carry[0], sh), jax.device_put(carry[1], sh), carry[2])

    one = tick(carry)
    one_sh = tick(carry_sh)
    # partitioned vs whole-batch compilations fuse the QP matmuls
    # differently → f32 rounding differences (measured ~1e-4 on x after one
    # tick); there are no collectives, so anything beyond rounding is a bug
    np.testing.assert_allclose(np.array(one_sh[0]), np.array(one[0]), atol=1e-3)
    assert one_sh[0].sharding.is_equivalent_to(sh, ndim=2)

    c = carry_sh
    for _ in range(30):
        c = tick(c)
    x = np.array(c[0])
    assert np.isfinite(x).all()
    assert (np.abs(x[:, 2]) < np.pi / 2).all()
    assert np.median(np.abs(x[:, 0])) < 0.3
