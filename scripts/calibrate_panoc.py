"""Calibrate the PANOC iteration budget against the reference's wall-clock caps.

The reference budgets every PANOC solve by wall-clock `max_duration`
(op-mpc-x.rs:160-161 DT=0.01 s; op-mpc-x-calc.rs:107 DT=0.1 s;
mpc-ukf-x.rs:275 1.5 s; mpc-ukf-s.rs:17,251 and mpc-ukf-commu.rs:19,285
DUR=0.03 s) with `max_iter(usize::MAX)`. Wall-clock deadlines are
untraceable under jit, so the rebuild uses fixed `max_iter` budgets
(controllers/panoc.py) — this script maps iterations → measured device µs
at every op-mpc config so the fixed budgets can be stated in the
reference's own wall-clock terms.

Method: per config, build the app's exact jitted solve with tol=0 (the
convergence test never fires, so the while_loop runs exactly max_iter
iterations), chain solves under lax.scan with per-step state variation,
and time two scan lengths — the marginal difference cancels the fixed
dispatch cost. Two
max_iter points give per-iteration µs and per-solve overhead by linear
fit. A final pass runs the app's REAL config (its tol and default
max_iter) on a representative closed-loop state and reports the
converged iteration count.

Run:  PYTHONPATH=. python scripts/calibrate_panoc.py   (from the repo root)
Writes PANOC_CALIBRATION.json at the repo root, keyed by JAX platform.
"""

from __future__ import annotations

import json
import math
import sys
import time

import jax

if "--cpu" in sys.argv:  # host-CPU column (the real-time path for tiny sequential solves)
    jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from mpc_rs_jax.controllers.panoc import (
    PanocConfig,
    box_projection,
    panoc_solve,
)
from mpc_rs_jax.controllers.qp import build_condensed_qp, make_qp_value_and_grad
from mpc_rs_jax.models import costs, dynamics, reference
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.utils import as_vector_fn


def _op_mpc_x():
    """op-mpc-x.rs: N=50 tracking-rollout cost, AD gradient, budget DT=0.01 s."""
    p = CartPoleParams.single_wheel_light()
    n = 50
    dt = 0.5 / n
    step = as_vector_fn(dynamics.make_cartpole_linear(p, dt), 4)
    pe = reference.make_planning_err(p.l)
    cost = costs.make_tracking_rollout_cost(
        step, pe, [0.0, 9.2, 16.0, 0.5, 0.0], barrier=1.0)
    x0 = jnp.asarray([3.0, 0.0, -0.7, 0.0])
    def make(cfg):
        def solve(x, u):
            return panoc_solve(cfg, lambda uu: cost(x, uu),
                               box_projection(-30.0, 30.0), u)
        return solve
    return make, x0, n, 0.01, 60


def _qp_case(params_name, t_hor, n, c_diag, limit, budget, default_iter,
             gen_ref_kind, two_wheel):
    p = getattr(CartPoleParams, params_name)()
    dt = t_hor / n
    a, b = dynamics.linear_ab(p, dt, two_wheel=two_wheel)
    qp = build_condensed_qp(a, b, np.diag(c_diag), n)
    if gen_ref_kind == "zero":
        gen_ref = reference.make_gen_ref_zero(n)
    elif gen_ref_kind == "raised":
        gen_ref = reference.make_gen_ref_raised_cosine(n)
    else:  # the commu variant's −0.75-velocity raised cosine
        def gen_ref(x):
            phases = jnp.arange(n) * (math.pi / n)
            r0 = x[0] * (1.0 + jnp.cos(phases)) / 2.0
            r1 = jnp.clip(-0.75 * x[0], -2.0, 2.0) * jnp.sin(phases)
            r2 = jnp.clip(-0.5 * x[0], -0.35, 0.35) * jnp.cos(phases) / 2.0
            r3 = jnp.clip(-0.5 * x[0], -1.5, 1.5) * jnp.sin(phases)
            return jnp.stack([r0, r1, r2, r3], axis=-1)
    vg_factory = make_qp_value_and_grad(qp, gen_ref)
    def make(cfg):
        def solve(x, u):
            return panoc_solve(cfg, None, box_projection(-limit, limit), u,
                               value_and_grad=vg_factory(x))
        return solve
    return make, jnp.asarray([0.5, 0.0, 0.1, 0.0]), n, budget, default_iter


def _mpc_ukf_x():
    """mpc-ukf-x.rs: N=10 scan cost with planner + cosh barrier, budget 1.5 s."""
    p = CartPoleParams.single_wheel_heavy_j()
    n = 10
    dt = 0.5 / n
    step = as_vector_fn(dynamics.make_cartpole_linear(p, dt), 4)
    next_plan = reference.make_next_plan(dt)
    plan_err = reference.make_plan_err(p.l)
    gain = [0.5, 0.5, 16.0, 3.0, 0.1]

    def cost(x0, u_seq):
        def body(carry, u):
            x, plan = carry
            x = step(x, u)
            plan = next_plan(plan)
            e = plan_err(x, plan)
            c = (gain[0] * e[0] ** 2 + gain[1] * e[1] ** 4
                 + gain[2] * e[2] ** 4 + gain[3] * e[3] ** 4
                 + gain[4] * u ** 2
                 + 1e-6 * jnp.maximum(jnp.cosh(x[2]) - 1.2, 0.0))
            return (x, plan), c
        (_, _), cs = jax.lax.scan(body, (x0, next_plan(x0)), u_seq)
        return jnp.sum(cs)

    def make(cfg):
        def solve(x, u):
            return panoc_solve(cfg, lambda uu: cost(x, uu),
                               box_projection(-30.0, 30.0), u)
        return solve
    return make, jnp.asarray([0.5, 0.0, -0.15, 0.0]), n, 1.5, 100


CASES = {
    # name: (builder, reference budget source)
    "op-mpc-x": (_op_mpc_x, "op-mpc-x.rs:160-161 (DT=0.01 s)"),
    "op-mpc-x-calc": (
        lambda: _qp_case("single_wheel", 0.8, 8, [5.0, 5.0, 1.0, 1.0],
                         30.0, 0.1, 80, "raised", False),
        "op-mpc-x-calc.rs:107 (DT=0.1 s)"),
    "mpc-ukf-x": (_mpc_ukf_x, "mpc-ukf-x.rs:275 (1.5 s)"),
    "mpc-ukf-s": (
        lambda: _qp_case("two_wheel", 1.2, 8, [1.0, 1.0, 10.0, 5.0],
                         10.0, 0.03, 60, "zero", True),
        "mpc-ukf-s.rs:17,251 (DUR=0.03 s)"),
    "mpc-ukf-commu": (
        lambda: _qp_case("two_wheel", 1.2, 40, [0.0, 0.0, 10.0, 3.0],
                         10.0, 0.03, 60, "commu", True),
        "mpc-ukf-commu.rs:19,285 (DUR=0.03 s)"),
}


def _chain(solve, n_solves):
    """M receding-horizon-style solves chained on-device: x varies per
    step, u warm-starts from the last result."""
    @jax.jit
    def f(x, u):
        def body(carry, i):
            x, u = carry
            res = solve(x + 1e-4 * i, u)
            return (x, res.u), res.u[0]
        (_, u), u0s = jax.lax.scan(body, (x, u), jnp.arange(n_solves, dtype=jnp.float32))
        return jnp.sum(u0s)
    return f


def _time_us(f, x, u, reps=3):
    out = []
    for i in range(reps):
        xv = x + 1e-5 * (i + 1)
        float(f(xv, u))  # warm up this input
        t0 = time.perf_counter()
        float(f(xv + 5e-6, u))
        out.append(time.perf_counter() - t0)
    return min(out) * 1e6


def main():
    results = {}
    for name, (builder, src) in CASES.items():
        make, x0, n, budget_s, default_iter = builder()
        u0 = jnp.zeros(n, jnp.float32)

        # per-iteration cost: tol=0 → while_loop runs exactly max_iter
        iters_lo, iters_hi = 20, 220
        per_solve = {}
        for it in (iters_lo, iters_hi):
            solve = make(PanocConfig(tol=0.0, max_iter=it, lbfgs_mem=20))
            n_s, n_l = 4, 24
            t_s = _time_us(_chain(solve, n_s), x0, u0)
            t_l = _time_us(_chain(solve, n_l), x0, u0)
            per_solve[it] = (t_l - t_s) / (n_l - n_s)
        per_iter_us = max(
            (per_solve[iters_hi] - per_solve[iters_lo]) / (iters_hi - iters_lo),
            1e-3,  # timing-noise floor: per-iter must be positive
        )
        overhead_us = per_solve[iters_lo] - per_iter_us * iters_lo
        iters_in_budget = (budget_s * 1e6 - overhead_us) / per_iter_us

        # converged iteration counts at the app's real config: cold first
        # solve, then warm-started (receding-horizon steady state)
        solve = jax.jit(make(PanocConfig(tol=1e-6, max_iter=default_iter, lbfgs_mem=20)))
        res = solve(x0, u0)
        cold_iters = int(res.iterations)
        u_w = res.u
        for j in range(4):
            res = solve(x0 + 1e-3 * (j + 1), u_w)
            u_w = res.u
        warm_iters = int(res.iterations)

        row = {
            "n_horizon": n,
            "reference_budget_s": budget_s,
            "reference_budget_source": src,
            "per_iteration_us": round(per_iter_us, 2),
            "per_solve_overhead_us": round(max(overhead_us, 0.0), 2),
            "default_max_iter": default_iter,
            "default_budget_us": round(overhead_us + per_iter_us * default_iter, 1),
            "iterations_in_reference_budget": int(iters_in_budget),
            "budget_headroom_x": round(iters_in_budget / default_iter, 1),
            "cold_start_iterations": cold_iters,
            "warm_start_iterations": warm_iters,
        }
        results[name] = row
        print(json.dumps({name: row}), flush=True)

    # platform-keyed merge: tiny sequential solves are launch-bound on an
    # accelerator, so the real-time story needs the CPU column beside it
    path = "PANOC_CALIBRATION.json"
    merged = {}
    try:
        with open(path) as f:
            merged = json.load(f)
    except (OSError, json.JSONDecodeError):
        pass
    merged[jax.default_backend()] = results
    with open(path, "w") as f:
        json.dump(merged, f, indent=1)
    print(f"\nwrote {path} [{jax.default_backend()}]")


if __name__ == "__main__":
    main()
