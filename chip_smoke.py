#!/usr/bin/env python
"""Smoke run of the engine on NVIDIA GPUs, through the entry points a user calls.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --gpus 4   # four GPUs: only the multi-device paths,
                                    # each compared with the same work on one

Phases (one process; each prints one line of its numbers):
  1. environment: card name and power limit, JAX, devices, flags, cache;
  2. the fused MPPI kernel against the plain reference on matched noise
     at K=10,240/N=8, K=819,200/N=8, K=800,000/N=20 (commu4) and batched
     B=1024/K=8192 (flagship controller), with µs per solve of the kernel
     and of both plain forms (scan and unrolled horizon);
  3. the in-kernel generator: 2^21 draws on the card, mean, variance and
     KS distance to N(0, 1), and equality with its plain-jnp twin;
  4. closed loops through apps/run.py: mppi4-non-liner at K=800,000, the
     flagship6 and cartpole4 fleets at B=1024, the QP fleet at B=1024,
     mppi4-ukf-commu against a simulated MCU at N=20 K=800,000, and serve
     with 8 simulated robots — with wall and compile seconds of each.

Any failed check raises, and the script exits non-zero without printing
its result. The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _line(phase: str, **nums) -> None:
    print(f"[{phase}] " + json.dumps(nums), flush=True)


class _CompileClock:
    """Seconds JAX spends tracing, lowering and compiling (cache hits
    included) while the clock is open."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


def phase_environment(jax) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from mpc_rs_jax.runtime.cache import enable_compile_cache

    _line("environment", jax=jax.__version__, devices=[str(d) for d in jax.devices()],
          xla_flags=os.environ.get("XLA_FLAGS", ""), compile_cache=enable_compile_cache(),
          matmul_precision=str(jax.config.jax_default_matmul_precision))


def _best_us(fn, *args, reps: int = 3, per: int = 1) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return 1e6 * best / per


def phase_kernel_vs_reference(jax) -> None:
    """Matched noise: the reference is given the kernel's own samples, as
    the compiled generator writes them out (kernel_normals), so both see
    bit-identical f32 perturbations. What differs is the order of f32
    reductions (per-block partials merged by log-sum-exp vs one XLA
    reduction) and FMA contraction in the rollout — score perturbations of
    ~1e-6 relative. The tolerance on u_n is 1e-3 of the control limit:
    where a few samples dominate the softmax, such perturbations can move
    their weights, but not by that much. Status must match exactly."""
    import jax.numpy as jnp
    import numpy as np

    from mpc_rs_jax.controllers.mppi import MppiConfig, finalize_partials, mppi_solve
    from mpc_rs_jax.models import costs, dynamics
    from mpc_rs_jax.models.params import CartPoleParams
    from mpc_rs_jax.ops.mppi_pallas import (kernel_normals, mppi_solve_pallas,
                                            mppi_solve_pallas_batch)
    from mpc_rs_jax.parallel.sharded_mppi import _jnp_partials

    sw, tw = CartPoleParams.single_wheel(), CartPoleParams.two_wheel()

    def chain(solve, chain_len):
        """A warm-started chain of solves on the device, one dispatch; long
        enough that the dispatch's fixed cost is small beside the solves."""
        def run(x, u):
            def body(u, j):
                u2, st = solve(j, x, u)
                return u2, st
            return jax.lax.scan(body, u, jnp.arange(chain_len, dtype=jnp.int32))
        return jax.jit(run)

    shapes = [
        ("k10240_n8", 10_240, 8, dynamics.make_cartpole_nonlinear(sw, 0.1), costs.shaped4, 0.5, 3.0, 20.0),
        ("k819200_n8", 819_200, 8, dynamics.make_cartpole_nonlinear(sw, 0.1), costs.shaped4, 0.5, 3.0, 20.0),
        ("commu4_k800000_n20", 800_000, 20, dynamics.make_commu4(tw, 1.2 / 20), costs.commu4, 2.0, 2.0, 10.0),
    ]
    for name, k, n, dyn, cost, lam, sd, lim in shapes:
        cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=lam, std_dev=sd, limit=(-lim, lim))
        x = jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32)
        u = jnp.zeros(n, jnp.float32)
        u_k, st_k = jax.jit(lambda x, u: mppi_solve_pallas(cfg, dyn, cost, 4, 11, x, u))(x, u)
        ref = jax.jit(lambda x, u: mppi_solve(cfg, dyn, cost, None, tuple(x), u,
                                              noise=sd * kernel_normals(11, 0, k, n)))(x, u)
        err = float(jnp.max(jnp.abs(u_k - ref.u_n)))
        tol = 1e-3 * lim
        assert int(st_k) == int(ref.status) == 0, (name, int(st_k), int(ref.status))
        assert err <= tol, (name, err, tol)
        chain_len = 200 if k < 100_000 else 20
        times = {
            "kernel_us": _best_us(chain(lambda s, x, u: mppi_solve_pallas(cfg, dyn, cost, 4, s, x, u),
                                        chain_len), x, u, per=chain_len),
        }
        for form, unroll in (("plain_scan_us", False), ("plain_unrolled_us", True)):
            def plain(s, x, u, unroll=unroll):
                r = mppi_solve(cfg, dyn, cost, jax.random.key(s), tuple(x), u, unroll=unroll)
                return r.u_n, r.status
            times[form] = _best_us(chain(plain, chain_len), x, u, per=chain_len)
        _line("kernel_vs_reference", shape=name, max_abs_err=err, tol=tol, status=int(st_k), **times)

    # batched: B=1024 scenarios of the flagship controller model, K=8192
    b, k, n, lim = 1024, 8192, 8, 10.0
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=1.4, std_dev=4.0, limit=(-lim, lim))
    dyn = dynamics.make_flagship4(tw, 1.2 / 8)
    cost = costs.make_diag4(0.1, 0.1, 1.0, 0.5)
    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.normal(0.0, [0.2, 0.2, 0.1, 0.2], (b, 4)), jnp.float32)
    u_ns = jnp.asarray(rng.normal(0.0, 1.0, (b, n)), jnp.float32)
    seeds = jnp.arange(b, dtype=jnp.int32) * 7919
    u_k, st_k = jax.jit(lambda xs, us: mppi_solve_pallas_batch(cfg, dyn, cost, 4, seeds, xs, us))(xs, u_ns)

    @jax.jit
    def batched_ref(xs, us):
        def one(seed, x, u):
            eps = cfg.std_dev * kernel_normals(seed, 0, k, n)
            return finalize_partials(cfg, _jnp_partials(cfg, dyn, cost, None, x, u, k, eps=eps), u)
        return jax.vmap(one)(seeds, xs, us)

    u_r, st_r = batched_ref(xs, u_ns)
    err = float(jnp.max(jnp.abs(u_k - u_r)))
    assert bool(jnp.all(st_k == st_r)), "batched status mismatch"
    assert err <= 1e-3 * lim, ("batched", err)

    chain_len = 20

    def batched_chain(solve):
        def run(xs, us):
            def body(us, j):
                return solve(j, xs, us)
            return jax.lax.scan(body, us, jnp.arange(chain_len, dtype=jnp.int32))
        return jax.jit(run)

    times = {"kernel_us": _best_us(batched_chain(
        lambda j, xs, us: mppi_solve_pallas_batch(cfg, dyn, cost, 4, seeds + j, xs, us)),
        xs, u_ns, per=chain_len)}
    for form, unroll in (("plain_scan_us", False), ("plain_unrolled_us", True)):
        def plain(j, xs, us, unroll=unroll):
            keys = jax.random.split(jax.random.key(j), b)
            parts = jax.vmap(lambda kk, x, u: _jnp_partials(cfg, dyn, cost, kk, x, u, k,
                                                            unroll=unroll))(keys, xs, us)
            return jax.vmap(lambda p, u: finalize_partials(cfg, p, u))(parts, us)
        times[form] = _best_us(batched_chain(plain), xs, u_ns, per=chain_len)
    _line("kernel_vs_reference", shape="batched_b1024_k8192_n8", max_abs_err=err, tol=1e-3 * lim,
          statuses_equal=True, **times)


def phase_generator(jax) -> None:
    """2^21 draws (2^18 rollouts × 8 steps) from the generator compiled into
    a Triton kernel. Bounds: |mean| < 5/√n, |var − 1| < 5·√(2/n), KS
    distance to N(0,1) below the 0.1% critical value 1.95/√n; and the
    draws equal the plain-jnp twin (the same uint32 words; the float
    transforms may differ in the last ulp between Triton and XLA)."""
    import jax.numpy as jnp
    import numpy as np
    from scipy.special import ndtr

    from mpc_rs_jax.ops.mppi_pallas import counter_normals, kernel_normals

    k, n_steps = 1 << 18, 8
    z = kernel_normals(12345, 3, k, n_steps)
    twin = counter_normals(12345, 3, k, n_steps)
    twin_err = float(jnp.max(jnp.abs(z - twin)))
    flat = np.sort(np.asarray(z, np.float64).ravel())
    n = flat.size
    mean, var = float(flat.mean()), float(flat.var())
    cdf = ndtr(flat)
    ks = float(max(np.max(np.arange(1, n + 1) / n - cdf), np.max(cdf - np.arange(n) / n)))
    bounds = {"mean": 5 / n**0.5, "var": 5 * (2 / n) ** 0.5, "ks": 1.95 / n**0.5, "twin": 1e-4}
    _line("generator", n=n, mean=mean, var=var, ks=ks, twin_max_abs_err=twin_err, bounds=bounds)
    assert abs(mean) < bounds["mean"] and abs(var - 1) < bounds["var"], (mean, var)
    assert ks < bounds["ks"], ks
    assert twin_err < bounds["twin"], twin_err


def phase_closed_loops(jax, clock: _CompileClock) -> None:
    import numpy as np

    from mpc_rs_jax.apps.run import main as run_main

    def run(name, argv, check):
        c0, t0 = clock.total, time.perf_counter()
        buf = io.StringIO()
        with tempfile.TemporaryDirectory() as td, contextlib.redirect_stdout(buf):
            ret = run_main(argv + ["--log-dir", td])
        out = buf.getvalue()
        nums = check(ret, out)
        _line("closed_loop", workload=name, wall_s=time.perf_counter() - t0,
              compile_s=clock.total - c0, **nums)

    def last(out, key):
        vals = [float(ln.split(key)[1].split()[0]) for ln in out.splitlines() if key in ln]
        assert vals, f"no '{key}' line in the output"
        return vals[-1]

    def chk_mppi4(ret, out):
        theta = float(abs(ret[2]))
        assert "over 60 degrees" not in out and theta < np.radians(60.0), theta
        return {"final_abs_theta": theta}

    def chk_fleet(min_survival):
        def chk(ret, out):
            s = last(out, "survival=")
            assert s >= min_survival, s
            report = [ln for ln in out.splitlines() if "survival=" in ln][-1]
            return {"survival": s,
                    "scenario_ticks_per_s": float(report.split()[-2].replace(",", ""))}
        return chk

    def chk_qp(ret, out):
        # the criterion of apps/acceptance.py's fleet-qp spec at B=1024;
        # its 100%-upright clause is for B=64, while 1024 random starts
        # include a few beyond recovery
        parked, upright = last(out, "parked="), last(out, "upright=")
        assert parked >= 0.95, (parked, upright)
        return {"parked_at_30_ticks": parked, "upright": upright}

    def chk_commu(ret, out):
        line = [ln for ln in out.splitlines() if ln.endswith(" packets")][-1]
        solves, packets = int(line.split()[0]), int(line.split()[2])
        assert packets >= 50 and "over pi/2" not in out, (packets, out[-300:])
        return {"solves": solves, "sensor3_packets": packets}

    def chk_serve(ret, out):
        assert ret["ticks"] > 5 and all(n > 0 for n in ret["rx"]) and all(n > 0 for n in ret["tx"])
        assert all(th < np.radians(60.0) for th in ret["max_abs_theta"]), ret["max_abs_theta"]
        return {"robots": ret["robots"], "ticks_per_s": ret["ticks_per_s"],
                "solve_ms_p50": ret["solve_ms_p50"], "max_abs_theta": max(ret["max_abs_theta"])}

    run("mppi4-non-liner_k800000", ["mppi4-non-liner"], chk_mppi4)
    run("fleet_flagship6_b1024_k8192_1000ticks",
        ["fleet", "--model", "flagship6", "--scenarios", "1024", "--t-end", "10",
         "--report-every", "10"], chk_fleet(0.99))
    run("fleet_cartpole4_b1024_k1024_200ticks",
        ["fleet", "--model", "cartpole4", "--scenarios", "1024", "--t-end", "10",
         "--report-every", "10"], chk_fleet(0.99))
    run("fleet_qp_b1024_30ticks", ["fleet", "--controller", "qp", "--scenarios", "1024",
                                   "--t-end", "3", "--report-every", "3"], chk_qp)
    run("mppi4-ukf-commu_n20_k800000", ["mppi4-ukf-commu", "--sim-mcu", "--t-end", "3"], chk_commu)
    run("serve_8_robots", ["serve", "--sim-mcu", "--robots", "8", "--t-end", "3"], chk_serve)


def phase_multi_device(jax, n: int) -> None:
    sys.path.insert(0, ROOT)
    from __graft_entry__ import dryrun_multichip

    t0 = time.perf_counter()
    errs = dryrun_multichip(n, interpret=False, full=True)
    _line("multi_device", devices=n, wall_s=time.perf_counter() - t0, max_abs_err=errs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-device paths on four GPUs")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    try:
        import mpc_rs_jax  # noqa: F401
    except ImportError:
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 1
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {devices[0].platform!r}", file=sys.stderr)
        return 1
    if len(devices) < args.gpus:
        print(f"--gpus {args.gpus} but JAX sees {len(devices)} GPU(s)", file=sys.stderr)
        return 1
    clock = _CompileClock()
    phase_environment(jax)
    if args.gpus > 1:
        phase_multi_device(jax, args.gpus)
    else:
        phase_kernel_vs_reference(jax)
        phase_generator(jax)
        phase_closed_loops(jax, clock)
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                             "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
