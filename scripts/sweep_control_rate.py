"""Solve-rate sensitivity sweep for the flagship estimator-in-loop flagship.

VERDICT round-1 Missing #3: the reference's control thread is unthrottled
(mppi4-non-liner-ukf.rs:54-99 — a loop with no sleep), so its *effective*
control rate equals its solve latency: K=5e5 · N=8 at the 64 M steps/s CPU
baseline (BASELINE.md) is ~62 ms/solve ≈ 16 Hz. Our deterministic multirate
loop replaces that wall-clock coupling with an explicit ``control_period``;
this sweep validates the approximation by measuring 10 s survival (2 N
pulse, estimator in loop) across seeds × control periods.

Result (recorded to SOLVE_RATE_SWEEP.json, cited in docs/PARITY.md), at
K=16384 over 20 seeds: 333 Hz → 19/20, 100 Hz → 18/20, 50 Hz → 20/20,
16.7 Hz → 15/20. Survival couples control rate with sampling budget:
holding a solve for 60 ms (the reference's effective rate) demands the
reference's K=5e5 solution quality, while very fast re-solving chases the
noisy estimate (σ_rpm=200 sensor noise) with fresh exploration noise every
3 ms. The (50 Hz, K=16384) point is robust on CPU-CI budgets, so the
acceptance spec pins it; the fleet's validated point is (100 Hz, K=8192)
with matched 100 Hz sensing and dt-scaled Q (DESIGN.md §4).

The sweep runs in a pool of worker processes pinned to the CPU on purpose:
a JAX process reserves most of a GPU's memory when it starts, so several
workers cannot share one card.

Usage: python scripts/sweep_control_rate.py [--seeds 20] [--jobs 4] [--k 16384]
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import contextlib
import io
import json
import tempfile
import time


def run_one(item):
    cp, seed, k = item
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from mpc_rs_jax.apps.run import main as run_main

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        argv = [
            "mppi4-non-liner-ukf", "--use-ukf-estimate", "--k", str(k),
            "--seed", str(seed), "--control-period", str(cp), "--log-dir", td,
        ]
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                ret = run_main(argv)
            ok = (not ret.tipped) and ret.t >= 9.5
        except Exception:
            ok = False
    return cp, seed, ok, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--k", type=int, default=16384)
    ap.add_argument("--periods", default="0.003,0.01,0.02,0.06")
    ap.add_argument("--out", default="SOLVE_RATE_SWEEP.json")
    args = ap.parse_args()

    periods = [float(p) for p in args.periods.split(",")]
    items = [(cp, s, args.k) for cp in periods for s in range(args.seeds)]
    res = {cp: {"passes": 0, "seeds": 0, "fail_seeds": []} for cp in periods}

    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with cf.ProcessPoolExecutor(max_workers=args.jobs, mp_context=ctx) as ex:
        for cp, seed, ok, dt in ex.map(run_one, items):
            r = res[cp]
            r["seeds"] += 1
            r["passes"] += ok
            if not ok:
                r["fail_seeds"].append(seed)
            print(f"cp={cp:6.3f}s seed {seed:2d} {'PASS' if ok else 'FAIL'} ({dt:5.1f}s)",
                  flush=True)

    payload = {
        "workload": "mppi4-non-liner-ukf --use-ukf-estimate (10 s, 2 N pulse)",
        "k": args.k,
        "note": "reference effective control rate ~16 Hz (unthrottled thread, "
                "solve-latency-limited at K=5e5 on its 64 M steps/s baseline)",
        "results": {
            str(cp): {
                "hz": round(1.0 / cp, 1),
                "seeds": r["seeds"],
                "passes": r["passes"],
                "rate": round(r["passes"] / max(1, r["seeds"]), 4),
                "fail_seeds": r["fail_seeds"],
            }
            for cp, r in res.items()
        },
    }
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(payload["results"], indent=1))


if __name__ == "__main__":
    main()
