"""True multi-process jax.distributed smoke test (VERDICT round-1 item 5).

Spawns 2 OS processes, each with 1 local CPU device, joined by
``init_distributed`` into a 2-device global mesh with Gloo collectives.
The K-sharded MPPI solve then runs ACROSS PROCESS BOUNDARIES — the same
code path a multi-host job uses across hosts (parallel/distributed.py,
parallel/sharded_mppi.py), exercised for real instead of only on a
single-process virtual mesh."""

import os
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent(
    """
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    pid = int(sys.argv[1])
    port = sys.argv[2]
    from mpc_rs_jax.parallel.distributed import init_distributed, global_rollout_mesh
    init_distributed(f"localhost:{port}", 2, pid)
    assert len(jax.devices()) == 2 and len(jax.local_devices()) == 1

    import jax.numpy as jnp
    import numpy as np
    from mpc_rs_jax.controllers.mppi import MppiConfig, mppi_solve
    from mpc_rs_jax.models import costs, dynamics
    from mpc_rs_jax.models.params import CartPoleParams
    from mpc_rs_jax.parallel.sharded_mppi import make_sharded_mppi

    p = CartPoleParams.single_wheel()
    step = dynamics.make_cartpole_nonlinear(p, 0.1)
    cfg = MppiConfig(n_horizon=8, n_rollouts=1024, lambda_=0.5, std_dev=3.0,
                     limit=(-20.0, 20.0))
    mesh = global_rollout_mesh()
    solve = make_sharded_mppi(cfg, step, costs.shaped4, 4, mesh, backend="jnp")
    x = jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32)
    u, st = solve(jax.random.key(0), x, jnp.zeros(8, jnp.float32))
    u = np.array(u)
    assert int(np.array(st)) == 0, st
    assert np.isfinite(u).all() and np.abs(u).max() > 0.1
    # cross-check: the 2-process sharded result matches a local solve with
    # the same semantics within MPPI sampling tolerance (weights differ by
    # shard-count only through the key folding, so compare loosely)
    r_local = mppi_solve(cfg, step, costs.shaped4, jax.random.key(0),
                         tuple(x), jnp.zeros(8, jnp.float32))
    assert np.sign(u[0]) == np.sign(float(r_local.u_n[0]))
    print(f"DIST_OK {pid} u0={u[0]:.3f}")
    """
)


_FLEET_WORKER = textwrap.dedent(
    """
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass
    pid = int(sys.argv[1])
    port = sys.argv[2]
    from mpc_rs_jax.parallel.distributed import init_distributed
    init_distributed(f"localhost:{port}", 2, pid)
    assert len(jax.devices()) == 2 and len(jax.local_devices()) == 1

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mpc_rs_jax.apps.fleet import build_fleet, build_qp_fleet
    from mpc_rs_jax.parallel.mesh import make_mesh

    # --- scenario-axis MPPI+UKF fleet across the process boundary (the
    # multi-host form of the north-star workload, SURVEY section 2d): 16
    # cartpole4 closed loops, 8 per process, AoS layout so every carry
    # leaf is batch-leading
    mesh = make_mesh({"scenario": 2, "rollouts": 1})
    tick, carry, dt, th_idx, guard = build_fleet(
        "cartpole4", 1024, "vmap", mesh, scenarios=16, ukf_layout="aos")
    # sigma_f is a dead NaN placeholder (overwritten by the first predict);
    # NaN != NaN trips jax's cross-process input-consistency check when the
    # uncommitted host carry is sharded onto the global mesh, so zero it.
    # (Uncommitted identical host arrays are auto-sharded per the tick's
    # in_specs across processes — same pattern as the solve test above;
    # device_put with a non-addressable NamedSharding is rejected.)
    carry = carry._replace(
        ukf=carry.ukf._replace(sigma_f=jnp.zeros_like(carry.ukf.sigma_f)))
    for _ in range(3):
        carry = tick(carry)
    jax.block_until_ready(carry)
    # each process checks its addressable shard (the global array spans
    # both processes)
    x_local = np.concatenate(
        [np.asarray(s.data) for s in carry.x.addressable_shards])
    assert x_local.shape == (8, 4), x_local.shape
    assert np.isfinite(x_local).all()
    assert np.all(np.abs(x_local[:, th_idx]) < guard)
    u_local = np.concatenate(
        [np.asarray(s.data) for s in carry.u_n.addressable_shards])
    assert np.isfinite(u_local).all() and np.abs(u_local).max() <= 10.0 + 1e-4

    # --- scenario-axis QP fleet (batched projected-Newton box QP) across
    # the same process boundary
    mesh_q = make_mesh({"scenario": 2})
    sh_q = NamedSharding(mesh_q, P("scenario"))
    rep_q = NamedSharding(mesh_q, P())
    tick_qp, (xq, uq, kq), _dt = build_qp_fleet(16)
    # build_qp_fleet's tick is a plain jit; pin global shardings so the
    # batch is REALLY partitioned across the two processes (GSPMD over the
    # scenario axis), not replicated per process
    tick_sharded = jax.jit(tick_qp,
                           in_shardings=((sh_q, sh_q, rep_q),),
                           out_shardings=(sh_q, sh_q, rep_q))
    for _ in range(30):
        xq, uq, kq = tick_sharded((xq, uq, kq))
    jax.block_until_ready(xq)
    xq_local = np.concatenate(
        [np.asarray(s.data) for s in xq.addressable_shards])
    assert np.isfinite(xq_local).all()
    assert np.all(np.abs(xq_local[:, 2]) < np.pi / 2)
    print(f"DIST_FLEET_OK {pid} theta_max={np.abs(x_local[:, th_idx]).max():.3f}")
    """
)


def _run_two_process(tmp_path, src: str, port: str, ok_tag: str):
    worker = tmp_path / "worker.py"
    worker.write_text(src)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # workers must not inherit the 8-virtual-device flag (1 local device each)
    env["XLA_FLAGS"] = ""
    env.pop("JAX_ENABLE_X64", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), port],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for pr in procs:
        out, _ = pr.communicate(timeout=220)
        outs.append(out)
    for pid, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"proc {pid} failed:\n{out[-2000:]}"
        assert f"{ok_tag} {pid}" in out, out[-2000:]


@pytest.mark.timeout(240)
def test_two_process_sharded_mppi(tmp_path):
    _run_two_process(tmp_path, _WORKER, "12399", "DIST_OK")


@pytest.mark.timeout(240)
def test_two_process_scenario_fleet(tmp_path):
    """Scenario-sharded closed loops (MPPI+UKF fleet AND the QP fleet)
    across a REAL OS-process boundary with Gloo collectives — the
    multi-host-shaped mesh for the north-star workload (VERDICT r4
    Next #7; SURVEY §2d scenario-parallel batch across hosts)."""
    _run_two_process(tmp_path, _FLEET_WORKER, "12421", "DIST_FLEET_OK")
