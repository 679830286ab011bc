"""Scenario-fleet runner — the BASELINE north star as a CLI workload.

Runs B independent MPPI+UKF closed loops batched on the device mesh,
reporting population statistics per report interval and supporting
checkpoint/resume of the full fleet state.

  python -m mpc_rs_jax.apps.run fleet --scenarios 1024 --t-end 10
  python -m mpc_rs_jax.apps.run fleet --model flagship6 --t-end 5
  python -m mpc_rs_jax.apps.run fleet --resume logs/fleet/fleet.npz

Operating points (validated to ≥0.99 / ≥0.95 survival with the estimator in
the loop — scripts/diag_fleet.py, scripts/diag_flagship.py):

- ``cartpole4``: the mppi4-non-liner-s.rs closed-loop config (σ=10,
  limit ±10, K=1024/scenario), 20 Hz control with the reference's 0.1 s
  model step, 100 Hz sensor at matched noise σ=[50,50,0.5]
  (mppi4-non-liner-s.rs:231-240), gen_q4 piecewise-white-noise UKF.
- ``flagship6``: the mppi4-non-liner-ukf.rs stack (two-wheel plant,
  UKF2(6,5) IMU observation, MPPI λ=1.4 σ=4 limit ±10, K=8192/scenario),
  100 Hz control/sensor at matched noise σ=[200,200,10,0.05,0.05] with the
  reference's R (:28,164), x0=0 and the reference's 2 N disturbance pulse
  during t∈(1,1.5) s (:237-247), tip-over guard |θ|>π/2 (:64-72).
"""

from __future__ import annotations

import math
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from mpc_rs_jax.apps.common import Elapsed
from mpc_rs_jax.controllers.mppi import MppiConfig
from mpc_rs_jax.estimators.ukf import ukf_init
from mpc_rs_jax.models import costs, dynamics, noise, observation
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.ops import resolve_backend
from mpc_rs_jax.parallel.mesh import make_mesh
from mpc_rs_jax.parallel.scenario import init_scenario_carry, make_scenario_step
from mpc_rs_jax.runtime.checkpoint import load_pytree, save_pytree
from mpc_rs_jax.utils import as_vector_fn


def _componentize_hx(hx_vec, n_obs):
    """Adapter: vector-form hx -> component form for the SoA estimator.
    The stack/slice pair is pure layout (fused away); hx internals already
    slice components, so the math stays elementwise on (B,) entries."""

    def hx_c(xs):
        z = hx_vec(jnp.stack(jnp.broadcast_arrays(*xs), axis=-1))
        return tuple(z[..., j] for j in range(n_obs))

    return hx_c


def build_fleet(model: str, k: int, backend: str, mesh, *, seed: int = 0,
                scenarios: int = 1024, feed_true_state: bool = False,
                sqrt_method: str | None = None, ukf_layout: str = "soa",
                interpret: bool = False, obs_normalize: bool | None = None,
                ukf_alpha: float | None = None):
    """(tick, carry0, dt_tick, theta_idx, guard_rad) for a fleet model.

    ``backend``: "pallas" (the fused MPPI kernel; ``interpret=True`` runs
    it in the Pallas interpreter) or "vmap" (the plain path). The
    controller's rollout model uses the polynomial sin/cos of
    ops/fastmath.py (the plant and estimator stay exact)."""
    n_dev = mesh.shape["rollouts"]
    # cartpole4: jittered Cholesky root (survival unaffected on this
    # near-isotropic filter; PERF.md has the GPU numbers for both roots).
    # flagship6: eigen-direction sigma placement is REQUIRED — the UT is
    # not invariant to the square-root choice through nonlinear fx, and on
    # this filter's anisotropic covariance the Cholesky sigma placement
    # costs real survival (CPU isolation: 0.88 vs 1.00; the reference chose
    # SVD for the same reason, src/ukf.rs:120-132). Default is the
    # unrolled-Jacobi eigen root: tip-for-tip identical to exact eigh across
    # seeds 0-3 at B=1024 (DESIGN.md §5).
    cart_sqrt = sqrt_method or "cholesky"
    # Sigma-point spread for the f32 fleet tiers: α=1 (Julier-spread sigma
    # points with the Merwe β=2 covariance correction; n+κ=3 unchanged),
    # NOT the reference's Merwe α=1e-3 (src/ukf.rs:23-28).
    # The UT is 2nd-order exact for any α, but its weights scale as
    # 1/(2α²(n+κ)) ≈ 1.7e5 at α=1e-3 — in f32 that multiplies the ~1e-7
    # ulp rounding of every propagated sigma point straight into the
    # predicted mean (measured: single-predict f32-vs-f64 deviation up to
    # O(1) per channel at α=1e-3 vs ~1e-7 at α=1 — a ~1e6× difference;
    # closed-loop the α=1e-3 f32 estimator inflates free-running θ-RMS
    # 0.135 → 0.17-0.18 while every α=1e-3 f64 twin matches the oracle;
    # scripts/diag_flagship_est_bisect.py). α=1 in f64 is distributionally
    # indistinguishable from α=1e-3 in f64 on this plant (same diag), so
    # the f32+α=1 tier recovers the reference's f64 behavior (validated
    # against the C++ oracle by scripts/parity_dist.py). Override with
    # ukf_alpha (e.g. 1e-3 to reproduce the raw-spread tier).
    fleet_alpha = 1.0 if ukf_alpha is None else ukf_alpha

    if model == "flagship6":
        dt = 0.01  # 100 Hz control+sensor (reference UKF thread: 9 ms sleep)
        k = k or 8192
        p = CartPoleParams.two_wheel()
        plant6 = dynamics.make_flagship6(p)

        def plant_fx(xv, u, f):
            out = plant6(*(xv[..., i] for i in range(6)), u, dt, f)
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

        def ukf_fx(xv, u):
            out = plant6(*(xv[..., i] for i in range(6)), u, dt, 0.0)
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

        ctrl_step = dynamics.make_flagship4(p, 1.2 / 8, fast=True)
        cost = costs.make_diag4(0.1, 0.1, 1.0, 0.5)
        hx_raw = observation.make_hx_imu6(p)
        sens_raw = jnp.asarray([200.0, 200.0, 10.0, 0.05, 0.05], jnp.float32)
        # Observation-channel normalization (opt-in): rescale z, hx and R
        # by 1/σ per channel — MATHEMATICALLY IDENTICAL filter (a fixed
        # diagonal change of obs coordinates; f64 equivalence pinned in
        # tests/test_ukf.py). It conditions the f32 innovation covariance
        # (raw Pz mixes O(1e7) geared-encoder terms with R=0.05 IMU
        # entries — ~8 decades), but a 200-episode validation
        # showed it does NOT move the est-in-loop θ-RMS distribution
        # (θ-RMS 0.167 normalized vs 0.169 raw vs the oracle's 0.135): the
        # pivoted-LU gain solve already survives the raw conditioning, and
        # the real f32 noise source was the α=1e-3 UT weight amplification
        # in PREDICT (see fleet_alpha above, which does close the gap).
        # Kept opt-in for ill-conditioned custom observation models.
        if obs_normalize is None:
            obs_normalize = False
        if obs_normalize:
            hx = lambda x: hx_raw(x) / sens_raw
            sens = jnp.ones(5, jnp.float32)            # injected std, scaled
            r_diag = (1.0 / sens_raw)                  # diag(σ)/σ² (σ-as-R kept)
        else:
            hx = hx_raw
            sens = sens_raw
            r_diag = sens_raw
        p0 = 0.1 * jnp.eye(6, dtype=jnp.float32)
        params, ukf0 = ukf_init(
            jnp.zeros(6, jnp.float32),
            p0,
            # ~2.15·dt in gen_q6's dt powers ≈ 10× Q: absorbs the unmodeled
            # 2 N push faster (diag sweep: survival 1.000 vs 0.953 at gen_q6(dt))
            noise.gen_q6(jnp.float32(2.15 * dt)).astype(jnp.float32),
            jnp.diag(r_diag),  # the reference's R (σ-as-R, mppi4-non-liner-ukf.rs:28,164)
            sqrt_method=sqrt_method or "jacobi",
            alpha=fleet_alpha,
        )
        cfg = MppiConfig(n_horizon=8, n_rollouts=k * n_dev if k % n_dev else k,
                         lambda_=1.4, std_dev=4.0, limit=(-10.0, 10.0))
        tick = make_scenario_step(
            cfg, ctrl_step, cost, plant_fx, params, ukf_fx, hx, sens, mesh,
            backend="pallas" if backend == "pallas" else "jnp",
            interpret=interpret,
            n_state=4, state_slice=(0, 1, 3, 4),
            n_substeps=1, dt_tick=dt, ukf_p_reset=p0,
            feed_true_state=feed_true_state,
            disturbance=lambda t: jnp.where(
                (t > 1.0) & (t < 1.5), jnp.float32(2.0), jnp.float32(0.0)
            ),
            # batch-minor estimator (estimators/ukf_soa.py)
            ukf_layout=ukf_layout,
            ukf_fx_c=lambda xs, u: tuple(jnp.broadcast_arrays(
                *plant6(*xs, u, dt, 0.0))),
            ukf_hx_c=_componentize_hx(hx, 5),
        )
        x0 = jnp.zeros(6, jnp.float32)
        theta_idx, guard = 3, math.pi / 2
    else:
        dt = 0.05  # 20 Hz control; model step stays T/N = 0.1
        n_substeps = 5  # 100 Hz plant/sensor/UKF
        k = k or 1024
        p = CartPoleParams.single_wheel()
        ctrl_step = dynamics.make_cartpole_nonlinear(p, 0.1, fast=True)
        fx = as_vector_fn(dynamics.make_cartpole_nonlinear(p, dt / n_substeps), 4)
        hx = observation.make_hx_rpm_gyro4(p)
        sens = jnp.asarray([50.0, 50.0, 0.5], jnp.float32)
        x0 = jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32)
        p0 = 0.1 * jnp.eye(4, dtype=jnp.float32)
        params, ukf0 = ukf_init(
            x0, p0, noise.gen_q4(dt / n_substeps).astype(jnp.float32), jnp.diag(sens * sens),
            sqrt_method=cart_sqrt, alpha=fleet_alpha,
        )
        cfg = MppiConfig(n_horizon=8, n_rollouts=k * n_dev if k % n_dev else k,
                         lambda_=0.5, std_dev=10.0, limit=(-10.0, 10.0))
        tick = make_scenario_step(
            cfg, ctrl_step, costs.shaped4, fx, params, fx, hx, sens, mesh,
            backend="pallas" if backend == "pallas" else "jnp", n_state=4,
            interpret=interpret,
            n_substeps=n_substeps, dt_tick=dt, ukf_p_reset=p0,
            feed_true_state=feed_true_state,
            ukf_layout=ukf_layout,
            ukf_fx_c=(lambda step_c: lambda xs, u: step_c(*xs, u))(
                dynamics.make_cartpole_nonlinear(p, dt / n_substeps)),
            ukf_hx_c=_componentize_hx(hx, 3),
        )
        theta_idx, guard = 2, math.radians(60.0)

    carry = init_scenario_carry(
        scenarios, x0, jnp.zeros(8, jnp.float32), ukf0, jax.random.key(seed),
        ukf_layout=ukf_layout,
    )
    return tick, carry, dt, theta_idx, guard


def build_qp_fleet(scenarios: int, *, seed: int = 0, max_iter: int = 60,
                   solver: str = "newton"):
    """Batched gradient-MPC fleet: B independent op-mpc-x-calc-nl parking
    problems (condensed QP, nonlinear plant — the model-mismatch benchmark,
    examples/op-mpc-x-calc.rs:73-98) solved per tick.

    ``solver="newton"`` (default): one batched projected-Newton box-QP
    solve (controllers/qp.py:box_qp_newton) — the linear terms for all B
    scenarios come from two matmuls (qp_linear_term) and each Newton
    iteration is (B,N) elementwise work, so the whole fleet tick is a
    handful of fused ops. ``solver="panoc"``: the general vmapped
    ``panoc_solve`` path (vmappable by design —
    tests/test_panoc.py::test_panoc_vmap_batched_scenarios); same
    minimizer (both KKT points of the same strictly convex QP), much
    slower per tick — kept as the parity/generality path.

    Returns (tick, carry0, dt). carry = (x (B,4), u_n (B,N), key)."""
    from mpc_rs_jax.controllers.panoc import PanocConfig, box_projection, panoc_solve
    from mpc_rs_jax.controllers.qp import (
        active_set_inverse_table,
        box_qp_newton,
        build_condensed_qp,
        make_qp_value_and_grad,
        qp_linear_term,
    )
    from mpc_rs_jax.models import reference

    p = CartPoleParams.single_wheel()
    t_hor, n = 0.8, 8
    dt = t_hor / n
    a, bm = dynamics.linear_ab(p, dt)
    c = np.diag([5.0, 5.0, 1.0, 1.0])
    qp = build_condensed_qp(a, bm, c, n, dtype=jnp.float32)
    gen_ref = reference.make_gen_ref_raised_cosine(n)
    lim = 30.0
    plant = as_vector_fn(dynamics.make_cartpole_nonlinear(p, dt), 4)

    if solver == "newton":
        # 256-entry active-set inverse table (64 KB): each Newton iteration
        # is a gather + matvec — removes the unrolled-Cholesky op flood that
        # dominates single-instance latency, with the same iterates to
        # 7e-12. From B=16 up the unrolled batched solve won where the
        # crossover was first measured; it has not been re-measured on the
        # GPU (ROADMAP).
        # ``max_iter`` is a PANOC knob; Newton's fixed 12 iterations are
        # past active-set settling for N=8 (iteration-count-invariant KKT
        # residual — tests/test_panoc.py).
        inv_tbl = active_set_inverse_table(qp.h) if scenarios < 16 else None

        def solve_batch(x, u_n):
            x_ref = jax.vmap(lambda xi: gen_ref(xi).reshape(-1))(x)
            b = qp_linear_term(qp, x, x_ref)
            # safeguard off: this fleet's condensed-QP instances are
            # KKT-exactness- and enumerator-verified without it
            # (tests/test_panoc.py, tests/test_native_oracle.py); skipping
            # the extra phases keeps the gate-validated tick cost
            return box_qp_newton(qp.h, b, u_n, -lim, lim, iters=12,
                                 inv_table=inv_tbl, safeguard=False)
    else:
        vg_factory = make_qp_value_and_grad(qp, gen_ref)
        cfg = PanocConfig(tol=1e-5, max_iter=max_iter, lbfgs_mem=10)
        proj = box_projection(-lim, lim)

        def solve_batch(x, u_n):
            return jax.vmap(
                lambda xi, ui: panoc_solve(cfg, None, proj, ui, value_and_grad=vg_factory(xi)).u
            )(x, u_n)

    @jax.jit
    def tick(carry):
        x, u_n, key = carry
        u_new = solve_batch(x, u_n)
        x_next = jax.vmap(plant)(x, u_new[:, 0])
        return (x_next, u_new, key)

    key = jax.random.key(seed)
    k1, k2 = jax.random.split(key)
    # spread of initial conditions around the reference's start (0.5, 0, 0.1, 0)
    x0 = jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32) + 0.2 * jax.random.normal(
        k1, (scenarios, 4), jnp.float32
    )
    carry = (x0, jnp.zeros((scenarios, n), jnp.float32), k2)
    return tick, carry, dt


def _run_qp_fleet(args):
    b = args.scenarios
    tick, carry, dt = build_qp_fleet(b, seed=args.seed, max_iter=args.max_iter or 60,
                                     solver=getattr(args, "qp_solver", "newton"))
    chunk = max(1, min(int(round(args.report_every / dt)), int(args.t_end / dt)))

    @jax.jit
    def run_chunk(c):
        c, _ = jax.lax.scan(lambda c, _: (tick(c), None), c, jnp.arange(chunk))
        return c

    el = Elapsed()
    n_ticks = int(args.t_end / dt)
    done = 0
    while done < n_ticks:
        t0 = time.perf_counter()
        carry = run_chunk(carry)
        x = np.array(carry[0])  # readback = sync
        wall = time.perf_counter() - t0
        done += chunk
        parked = float((np.abs(x[:, 0]) < 0.3).mean())
        upright = float((np.abs(x[:, 2]) < math.pi / 2).mean())
        print(
            f"t={done*dt:6.1f}s  parked={parked:6.3f}  upright={upright:6.3f}  "
            f"median|x|={float(np.median(np.abs(x[:, 0]))):.3f}  "
            f"{b*chunk/wall:,.0f} scenario-ticks/s"
        )
    el.print()
    return carry


def fleet(args):
    if getattr(args, "controller", "mppi") == "qp":
        return _run_qp_fleet(args)
    b = args.scenarios
    backend = resolve_backend(args.backend)
    n_dev = len(jax.devices())
    mesh = make_mesh({"scenario": 1, "rollouts": n_dev})
    tick, carry, dt, theta_idx, guard = build_fleet(
        args.model, args.k, backend, mesh, seed=args.seed, scenarios=b,
        sqrt_method=getattr(args, "sqrt_method", None),
        ukf_layout=getattr(args, "ukf_layout", None) or "soa",
        ukf_alpha=getattr(args, "ukf_alpha", None),
    )
    ckpt_backend = getattr(args, "ckpt_backend", None) or "npz"
    ckpt_name = "fleet.npz" if ckpt_backend == "npz" else "fleet_orbax"
    ckpt_path = os.path.join(args.log_dir, "fleet", ckpt_name)
    if args.resume:
        # backend inferred from the path (an orbax checkpoint is a directory)
        resume_backend = "orbax" if os.path.isdir(args.resume) else "npz"
        carry = load_pytree(args.resume, carry, backend=resume_backend)
        print(f"resumed fleet from {args.resume}")

    chunk = max(1, min(int(round(args.report_every / dt)), int(args.t_end / dt)))

    @jax.jit
    def run_chunk(c):
        def body(c, _):
            c = tick(c)
            return c, jnp.abs(c.x[:, theta_idx])

        c, th = jax.lax.scan(body, c, jnp.arange(chunk))
        return c, jnp.max(th, axis=0)  # per-scenario max |θ| within chunk

    el = Elapsed()
    n_ticks = int(args.t_end / dt)
    done = 0
    ever_tipped = np.zeros(b, bool)
    while done < n_ticks:
        t0 = time.perf_counter()
        carry, th_max = run_chunk(c=carry)
        th_max = np.array(th_max)  # readback = sync
        wall = time.perf_counter() - t0
        done += chunk
        ever_tipped |= th_max > guard
        surv = 1.0 - ever_tipped.mean()
        print(
            f"t={done*dt:6.1f}s  survival={surv:6.3f}  median max|θ|={float(np.median(th_max)):.4f}  "
            f"{b*chunk/wall:,.0f} scenario-ticks/s"
        )
        save_pytree(ckpt_path, carry, backend=ckpt_backend)
    el.print()
    print(f"checkpoint: {ckpt_path}")
    return carry
