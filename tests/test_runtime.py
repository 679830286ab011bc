"""Runtime: checkpoint/resume, profiler, CSV logger, multirate loop, scaling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_rs_jax.controllers.mppi import MppiConfig
from mpc_rs_jax.estimators.ukf import ukf_init
from mpc_rs_jax.models import costs, dynamics
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.parallel.scaling import measure_scaling
from mpc_rs_jax.runtime.checkpoint import load_pytree, save_pytree
from mpc_rs_jax.runtime.logger import CsvLogger
from mpc_rs_jax.runtime.loop import MultiRateConfig, pulse_disturbance, run_multirate_loop
from mpc_rs_jax.runtime.profiler import SolveTimer


def test_checkpoint_roundtrip(tmp_path):
    params, state = ukf_init(jnp.arange(4.0), 2.0 * jnp.eye(4), jnp.eye(4), jnp.eye(3))
    ckpt = {"u_n": jnp.arange(8.0, dtype=jnp.float32), "ukf": state}
    path = str(tmp_path / "ctrl.npz")
    save_pytree(path, ckpt)
    template = {"u_n": jnp.zeros(8, jnp.float32), "ukf": state}
    restored = load_pytree(path, template)
    np.testing.assert_array_equal(np.array(restored["u_n"]), np.arange(8.0))
    np.testing.assert_array_equal(np.array(restored["ukf"].x), np.arange(4.0))
    assert restored["u_n"].dtype == jnp.float32


def test_checkpoint_orbax_roundtrip_preserves_sharding(tmp_path):
    # production backend: atomic commit + native sharded-jax.Array restore
    # (a mesh-sharded fleet carry comes back WITH its placement, which the
    # npz round-trip through host numpy cannot do)
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("scenario",))
    sh = NamedSharding(mesh, P("scenario"))
    fleet_x = jax.device_put(jnp.arange(64.0, dtype=jnp.float32).reshape(16, 4), sh)
    ckpt = {
        "x": fleet_x,
        "u_n": jnp.ones((16, 8), jnp.float32),
        "key": jax.random.key(42),
    }
    path = str(tmp_path / "fleet_orbax")
    save_pytree(path, ckpt, backend="orbax")
    template = {
        "x": fleet_x,  # carries the target sharding
        "u_n": jnp.zeros((16, 8), jnp.float32),
        "key": jax.random.key(0),
    }
    restored = load_pytree(path, template, backend="orbax")
    np.testing.assert_array_equal(np.array(restored["x"]), np.array(fleet_x))
    assert restored["x"].sharding == sh  # placement preserved
    np.testing.assert_array_equal(
        jax.random.key_data(restored["key"]), jax.random.key_data(ckpt["key"])
    )
    # keys restored as typed keys, usable directly
    jax.random.normal(restored["key"], (2,))


def test_checkpoint_unknown_backend(tmp_path):
    import pytest

    with pytest.raises(ValueError):
        save_pytree(str(tmp_path / "x"), {"a": jnp.zeros(2)}, backend="hdf5")


def test_checkpoint_leaf_mismatch(tmp_path):
    path = str(tmp_path / "bad.npz")
    save_pytree(path, {"a": jnp.zeros(3)})
    try:
        load_pytree(path, {"a": jnp.zeros(3), "b": jnp.zeros(2)})
        assert False, "expected ValueError"
    except ValueError:
        pass


def test_solve_timer():
    t = SolveTimer("t")
    f = t.wrap(lambda x: jnp.sum(x * x))
    for _ in range(5):
        f(jnp.arange(128.0))
    s = t.summary()
    assert s["count"] == 5 and s["mean_ms"] > 0 and s["p99_ms"] >= s["p50_ms"]


def test_csv_logger_flattens(tmp_path):
    path = str(tmp_path / "log.csv")
    with CsvLogger(path) as lg:
        lg.write_row(0.1, 2.0, np.array([1.0, 2.0, 3.0]))
        lg.write_row(0.2, 3.0, np.array([4.0, 5.0, 6.0]))
    data = np.loadtxt(path, delimiter=",")
    assert data.shape == (2, 5)
    np.testing.assert_allclose(data[0], [0.1, 2.0, 1.0, 2.0, 3.0])


def test_multirate_loop_deterministic():
    """Same seeds → identical trajectories (the reference's thread soup is
    wall-clock nondeterministic; ours must not be)."""
    p = CartPoleParams.single_wheel()
    plant = dynamics.make_cartpole_nonlinear(p, None)

    def plant_step(x, u, dt, f):
        return np.array([float(v) for v in plant(*x, u, dt)])

    def run_once():
        cfg = MultiRateConfig(
            dt_phys=5e-3, sensor_period=1e-2, control_period=2e-2, t_end=0.3,
            disturbance=pulse_disturbance(0.1, 0.2, 1.0),
        )
        rng = np.random.default_rng(0)
        hist = run_multirate_loop(
            cfg,
            plant_step=plant_step,
            sensor=lambda r, x: x[:3] + r.normal(size=3) * 0.01,
            est_predict_update=lambda est, u, z, dt: est,
            est_state=lambda est: np.zeros(4),
            controller=lambda key, xh, u_n: (u_n + 0.1, 0),
            predictor=None,
            x0=np.array([0.1, 0.0, 0.05, 0.0]),
            u0=np.zeros(4, np.float64),
            est0=None,
            key=jax.random.key(0),
            rng=rng,
            debug_ukf_bypass=True,
        )
        return hist

    r1, r2 = run_once(), run_once()
    np.testing.assert_array_equal(r1.x, r2.x)
    assert r1.n_solves == r2.n_solves


def test_scaling_harness_runs_on_virtual_mesh():
    p = CartPoleParams.single_wheel()
    cfg = MppiConfig(n_horizon=8, n_rollouts=8 * 256, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    step = dynamics.make_cartpole_nonlinear(p, 0.1)
    res = measure_scaling(cfg, step, costs.shaped4, 4, device_counts=[1, 8], iters=3)
    assert [r["devices"] for r in res] == [1, 8]
    assert all(r["solves_per_s"] > 0 for r in res)
    assert res[0]["speedup"] == 1.0


def test_multirate_free_running_controller():
    """control_period=None re-solves every physics tick — the reference's
    unthrottled control threads (mppi4-non-liner-ukf.rs:54-99)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpc_rs_jax.runtime.loop import MultiRateConfig, run_multirate_loop

    calls = {"n": 0}

    def controller(key, xh, u_n):
        calls["n"] += 1
        return u_n, 0

    mr = MultiRateConfig(dt_phys=1e-2, sensor_period=5e-2, control_period=None,
                         log_period=1.0, t_end=0.5)
    res = run_multirate_loop(
        mr,
        plant_step=lambda x, u, dtp, f: x,
        sensor=lambda rng, x: x[:1],
        est_predict_update=lambda est, u, z, dte: est,
        est_state=lambda est: np.zeros(4),
        controller=controller,
        predictor=None,
        x0=np.zeros(4),
        u0=jnp.zeros(4),
        est0=None,
        key=jax.random.key(0),
        rng=np.random.default_rng(0),
    )
    # one solve per physics tick (50 ticks in 0.5 s at 10 ms)
    assert res.n_solves >= 49, res.n_solves


def test_checkpoint_orbax_missing_is_a_clear_error(tmp_path, monkeypatch):
    """orbax is optional: without it the orbax backend says what to do."""
    import sys

    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    with pytest.raises(ImportError, match="backend='npz'"):
        save_pytree(str(tmp_path / "x"), {"a": jnp.zeros(2)}, backend="orbax")
