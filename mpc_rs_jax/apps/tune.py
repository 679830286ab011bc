"""Batched hyperparameter sweep: the whole (λ, σ) grid as ONE device call.

The reference tunes MPPI by editing compile-time consts and re-running —
its files carry the tuning history as commented-out alternates
(examples/op-mpc-x.rs:16-61, and the K/λ/σ const blocks of every mppi4*
example, e.g. examples/mppi4-non-liner.rs:8-18). Each hand trial costs a
rebuild plus a full wall-clock episode.

Here the sweep is data: λ and σ enter ``mppi_solve`` as traced
values, so a full closed-loop episode is vmappable over them. This runner
evaluates an L×S grid × R seeds = B independent episodes (plant =
mppi4-non-liner nonlinear cart-pole, its x₀=[0.5,0,0.1,0] init and
|θ|>60° tip-over guard, examples/mppi4.rs:30,50-53) in a single jitted
scan-over-ticks, and reports per-cell survival, mean accumulated cost, and
mean softmax effective sample size (the standard λ health signal:
ESS→K means λ too hot / averaging everything, ESS→1 means λ too cold /
winner-take-all).

Run (defaults reproduce the reference's neighborhood: λ=0.5, σ=3):

    python -m mpc_rs_jax.apps.run tune --lambdas 0.1,0.5,1.4,2.5 \
        --sigmas 1,3,10 --tune-seeds 8 --k 1024
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from mpc_rs_jax.apps.common import DEG60
from mpc_rs_jax.controllers.mppi import MppiConfig, mppi_solve
from mpc_rs_jax.models import costs, dynamics
from mpc_rs_jax.models.params import CartPoleParams


def make_sweep(*, k: int, n_horizon: int = 8, dt: float = 0.1,
               n_ticks: int = 50, limit=(-20.0, 20.0)):
    """Returns jitted ``sweep(lambdas (B,), sigmas (B,), seeds (B,)) ->
    (survived (B,), total_cost (B,), mean_ess (B,))``.

    One episode per entry: closed loop on the nonlinear cart-pole
    (examples/mppi4-non-liner.rs:81-94 dynamics, shaped cost :20-27),
    controller model == plant (the reference's open-loop-sim posture),
    warm-started u_n carried across ticks (examples/mppi4.rs:42).
    """
    p = CartPoleParams.single_wheel()
    step = dynamics.make_cartpole_nonlinear(p, dt)
    cost = costs.shaped4

    def episode(lam, sig, seed):
        cfg = MppiConfig(n_horizon=n_horizon, n_rollouts=k, lambda_=lam,
                         std_dev=sig, limit=limit)
        x0 = tuple(jnp.asarray(v, jnp.float32) for v in (0.5, 0.0, 0.1, 0.0))
        u0 = jnp.zeros(n_horizon, jnp.float32)

        def tick(carry, key):
            x, u_n, tipped, c_acc, ess_acc, alive = carry
            r = mppi_solve(cfg, step, cost, key, x, u_n)
            x = step(*x, r.u_n[0])
            was_tipped = tipped
            tipped = tipped | (jnp.abs(x[2]) > DEG60)  # examples/mppi4.rs:50-53
            c_acc = c_acc + cost(*x)
            # ESS is a λ-health signal for the *upright* loop: stop
            # accumulating once the tip-over latch fires so post-fall solves
            # can't skew the per-cell mean (it sits next to mean_cost, which
            # is survivor-conditioned).
            ess_acc = ess_acc + jnp.where(was_tipped, 0.0, r.ess)
            alive = alive + (~was_tipped).astype(jnp.float32)
            return (x, r.u_n, tipped, c_acc, ess_acc, alive), None

        keys = jax.random.split(jax.random.key(seed), n_ticks)
        init = (x0, u0, jnp.bool_(False), jnp.float32(0.0), jnp.float32(0.0),
                jnp.float32(0.0))
        (x, _, tipped, c_acc, ess_acc, alive), _ = jax.lax.scan(tick, init, keys)
        return ~tipped, c_acc, ess_acc / jnp.maximum(alive, 1.0)

    return jax.jit(jax.vmap(episode))


def sweep_grid(lambdas, sigmas, *, seeds: int, k: int, n_ticks: int = 50,
               seed0: int = 0):
    """Evaluate the L×S×R grid; returns a list of per-cell dicts."""
    lam_g, sig_g, seed_g = np.meshgrid(
        np.asarray(lambdas, np.float32), np.asarray(sigmas, np.float32),
        seed0 + np.arange(seeds, dtype=np.int32), indexing="ij",
    )
    run = make_sweep(k=k, n_ticks=n_ticks)
    survived, total_cost, mean_ess = run(
        jnp.asarray(lam_g.ravel()), jnp.asarray(sig_g.ravel()),
        jnp.asarray(seed_g.ravel()),
    )
    surv = np.asarray(survived).reshape(lam_g.shape)
    costt = np.asarray(total_cost).reshape(lam_g.shape)
    ess = np.asarray(mean_ess).reshape(lam_g.shape)
    cells = []
    for i, lam in enumerate(lambdas):
        for j, sig in enumerate(sigmas):
            s = surv[i, j]
            cells.append({
                "lambda": float(lam),
                "sigma": float(sig),
                "survival": float(s.mean()),
                # cost and ESS averaged over surviving episodes only (a
                # tipped episode's trajectory after the guard is
                # meaningless); None — serialized as JSON null, keeping
                # tune.json strict-JSON parseable — when every seed tipped
                "mean_cost": float(costt[i, j][s].mean()) if s.any() else None,
                "mean_ess": float(ess[i, j][s].mean()) if s.any() else None,
                "seeds": int(s.size),
            })
    return cells


def tune(args):
    """CLI: grid sweep, table to stdout, JSON to <log-dir>/tune/tune.json."""
    lambdas = [float(v) for v in args.lambdas.split(",") if v]
    sigmas = [float(v) for v in args.sigmas.split(",") if v]
    k = args.k or 1024
    n_ticks = max(1, round(args.t_end / 0.1))
    cells = sweep_grid(lambdas, sigmas, seeds=args.tune_seeds, k=k,
                       n_ticks=n_ticks, seed0=args.seed)

    print(f"[tune] {len(lambdas)}x{len(sigmas)} grid x {args.tune_seeds} seeds, "
          f"K={k}, {n_ticks} ticks ({n_ticks * 0.1:.1f} s) per episode "
          f"— {len(cells) * args.tune_seeds} episodes in one device call")
    print(f"{'lambda':>8} {'sigma':>8} {'survival':>9} {'mean_cost':>12} {'mean_ESS':>9}")
    for c in cells:
        cost_s = f"{c['mean_cost']:12.2f}" if c["mean_cost"] is not None else f"{'—':>12}"
        ess_s = f"{c['mean_ess']:9.1f}" if c["mean_ess"] is not None else f"{'—':>9}"
        print(f"{c['lambda']:8.3g} {c['sigma']:8.3g} {c['survival']:9.2f} "
              f"{cost_s} {ess_s}")
    inf = float("inf")
    best = min(cells, key=lambda c: (-c["survival"],
                                     inf if c["mean_cost"] is None else c["mean_cost"]))
    best_cost = "—" if best["mean_cost"] is None else f"{best['mean_cost']:.1f}"
    print(f"[tune] best cell: lambda={best['lambda']:g} sigma={best['sigma']:g} "
          f"(survival {best['survival']:.2f}, cost {best_cost})")

    out_dir = os.path.join(args.log_dir, "tune")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "tune.json")
    with open(path, "w") as f:
        json.dump({"k": k, "n_ticks": n_ticks, "seeds": args.tune_seeds,
                   "cells": cells}, f, indent=1)
    print(f"[tune] wrote {path}")
    return cells
