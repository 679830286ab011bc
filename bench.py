#!/usr/bin/env python
"""Headline benchmark: MPPI solves/s on one GPU (K=10,240, 8-step horizon)
on the mppi4-non-liner config (BASELINE.json metric), plus the reference's
larger single-solve budgets, the MPPI+UKF fleets and the QP fleet.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "solves/s", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": ...}, ...}

Baseline: the reference's implied real-time CPU throughput is 64 M
rollout-steps/s (BASELINE.md — K·N/DT = 6.4e6/0.1 s on a multicore x86 via
rayon). At K=10240, N=8 that is 81.9k steps/solve → 781 solves/s.

Every solve runs through the path the apps use (ops.resolve_backend: the
fused kernel on a GPU). Solves are chained device-resident under
``lax.scan`` (warm-started u_n), and each timing is the best of a few
repeats of a whole chain, ended by ``block_until_ready``. With no GPU the
benchmark exits non-zero rather than timing the CPU.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_STEPS_PER_S = 64e6


def _best_seconds(fn, *args, reps: int = 3) -> float:
    jax.block_until_ready(fn(*args))  # compile + warm up
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _solve_chain_us(cfg, dyn, cost, x0, n_solves, plant=None) -> float:
    """µs per solve of a device-resident receding-horizon chain."""
    from mpc_rs_jax.ops.mppi_pallas import mppi_pallas_chain

    run = jax.jit(lambda x, u: mppi_pallas_chain(
        cfg, dyn, cost, 4, None, x, u, plant=plant, n_solves=n_solves))
    u0 = jnp.zeros(cfg.n_horizon, jnp.float32)
    return 1e6 * _best_seconds(run, jnp.asarray(x0, jnp.float32), u0) / n_solves


def _bench_single_solves() -> dict:
    from mpc_rs_jax.controllers.mppi import MppiConfig
    from mpc_rs_jax.models import costs, dynamics
    from mpc_rs_jax.models.params import CartPoleParams

    sw, tw = CartPoleParams.single_wheel(), CartPoleParams.two_wheel()
    step = dynamics.make_cartpole_nonlinear(sw, 0.8 / 8)
    out = {}
    for k, n_solves in ((10240, 500), (819200, 50)):
        cfg = MppiConfig(n_horizon=8, n_rollouts=k, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
        us = _solve_chain_us(cfg, step, costs.shaped4, [0.5, 0.0, 0.1, 0.0], n_solves)
        out[f"k{k}_us_per_solve"] = us
        out[f"k{k}_rollout_steps_per_s"] = k * 8 / (us * 1e-6)
    # mppi4-ukf-commu's MPPI at the reference's own budget (T=1.2, N=20,
    # K=8e5, λ=2, σ=2, ±10 — examples/mppi4-ukf-commu.rs:15-22), the plant
    # advancing one step per solve; the reference's real-time budget is
    # DT=T/N=0.06 s per solve
    n, k = 20, 800_000
    dyn = dynamics.make_commu4(tw, 1.2 / n)
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=2.0, std_dev=2.0, limit=(-10.0, 10.0))
    us = _solve_chain_us(cfg, dyn, costs.commu4, [0.0, 0.0, 0.1, 0.0], 20, plant=dyn)
    out["hw_n20_k800000_us_per_solve"] = us
    out["hw_n20_realtime_headroom"] = 0.06 / (us * 1e-6)
    return out


def _bench_fleet(model: str, ticks: int, batch: int = 1024) -> dict:
    """Batched MPPI+UKF closed loops: ms per tick and survival (no tip-over
    over the whole run; flagship6 includes the reference's 2 N pulse)."""
    from mpc_rs_jax.apps.fleet import build_fleet
    from mpc_rs_jax.ops import resolve_backend
    from mpc_rs_jax.parallel.mesh import make_mesh

    mesh = make_mesh({"scenario": 1, "rollouts": 1}, devices=jax.devices()[:1])
    tick, carry, dt, theta_idx, guard = build_fleet(model, 0, resolve_backend(), mesh,
                                                    scenarios=batch)

    @jax.jit
    def run(c):
        def body(c, _):
            c = tick(c)
            return c, jnp.abs(c.x[:, theta_idx])

        c, th = jax.lax.scan(body, c, jnp.arange(ticks))
        return jnp.max(th, axis=0)

    sec = _best_seconds(run, carry, reps=2)
    th_max = np.asarray(run(carry))
    return {
        f"{model}_scenarios": batch,
        f"{model}_ms_per_tick": 1e3 * sec / ticks,
        f"{model}_scenario_ticks_per_s": batch * ticks / sec,
        f"{model}_survival_{ticks}_ticks": float((th_max < guard).mean()),
    }


def _bench_qp(batch: int, ticks: int) -> dict:
    """Batched box-QP fleet (projected Newton, nonlinear plant) µs per
    tick, and the parked fraction at 30 ticks (3 s sim)."""
    from mpc_rs_jax.apps.fleet import build_qp_fleet

    tick, carry, dt = build_qp_fleet(batch)

    def make(n):
        return jax.jit(lambda c: jax.lax.scan(lambda c, _: (tick(c), None), c, jnp.arange(n))[0])

    sec = _best_seconds(make(ticks), carry)
    out = {f"qp_b{batch}_us_per_tick": 1e6 * sec / ticks}
    if batch > 1:
        x = np.asarray(make(30)(carry)[0])
        out[f"qp_b{batch}_parked_frac"] = float((np.abs(x[:, 0]) < 0.3).mean())
    return out


def main():
    from mpc_rs_jax.ops import kernel_available
    from mpc_rs_jax.runtime.cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if not kernel_available(dev):
        sys.exit(f"bench.py times the GPU; JAX found no GPU (platform {dev.platform!r})")
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}}
    out.update(_bench_single_solves())
    out.update(_bench_fleet("cartpole4", ticks=200))
    out.update(_bench_fleet("flagship6", ticks=1000))
    out.update(_bench_qp(1024, 1000))
    out.update(_bench_qp(1, 1000))
    solves_10k = 1e6 / out["k10240_us_per_solve"]
    head = {
        "metric": "MPPI solves/s on one GPU (K=10240 rollouts, 8-step horizon, "
                  "nonlinear cart-pole, device-resident loop)",
        "value": solves_10k,
        "unit": "solves/s",
        "vs_baseline": solves_10k / (BASELINE_STEPS_PER_S / (10240 * 8)),
    }
    print(json.dumps({**head, **out}))


if __name__ == "__main__":
    main()
