"""Behavioral acceptance harness — machine-checked pass criteria for every
reference workload, evaluated over many seeds (VERDICT round-1 item 1).

Each spec encodes the reference's own de-facto pass signal (SURVEY §4:
survive t_end without tip-over, park within tolerance, converge) as a
predicate on (runner return value, captured stdout). Results go to
PARITY_RESULTS.json; docs/PARITY.md cites the recorded rates.

  python -m mpc_rs_jax.apps.acceptance --seeds 20 --jobs 4
  python -m mpc_rs_jax.apps.acceptance --only mppi4 --seeds 3

Criteria use the reference guards verbatim (60° tip for mppi4 family —
examples/mppi4.rs:50-53; π/2 for the flagship/QP loops — mpc-ukf-s.rs:63-72;
parking for op-mpc-x* — op-mpc-x.rs:263-266). Scale (K) is reduced for CPU
CI speed where noted; the criterion is never loosened.

The harness runs its specs in a pool of worker processes, each pinned to
the CPU on purpose: a JAX process reserves most of a GPU's memory when it
starts, so several workers cannot share one card. The full-scale runs on
the GPU are chip_smoke.py's, in one process.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import contextlib
import io
import json
import os
import tempfile
import time
import traceback


def _finite(x):
    import numpy as np

    return bool(np.all(np.isfinite(np.asarray(x, dtype=np.float64))))


# ---- per-workload checks: (ret, out) -> bool ------------------------------

def chk_mppi2(ret, out):
    import numpy as np

    x = np.asarray(ret)
    return _finite(x) and abs(x[0]) < 0.3 and abs(x[1]) < 0.3  # regulated


def chk_no_tip60(ret, out):
    return _finite(ret) and "over 60 degrees" not in out


def chk_multirate_survives(ret, out):
    return (not ret.tipped) and ret.t >= 9.5


def chk_op_en2(ret, out):
    # min u² on the unit ball: unconstrained optimum 0 lies inside
    return abs(float(ret.u[0])) < 1e-3 and abs(float(ret.u[1])) < 1e-3


def chk_parks(ret, out):
    import numpy as np

    x = np.asarray(ret)
    return _finite(x) and "over pi/2" not in out and "Error:" not in out \
        and abs(x[0]) < 0.3 and abs(x[2]) < 0.1


def chk_mpc_ukf_x_faithful(ret, out):
    # proven reference behavior (docs/MPC_UKF_X_ANALYSIS.md): the cart does
    # NOT park — it either glides away under the π/2 guard (most seeds) or
    # noise tips the ride past π/2 (the reference's own bail path). What
    # would falsify parity is stabilizing at the origin.
    import numpy as np

    x = np.asarray(ret)
    glided = "Error:" not in out and abs(x[2]) < np.pi / 2 and abs(x[0]) > 10.0
    tipped = "Error:" in out
    return glided or tipped


def chk_pid_tips(ret, out):
    # the reference PID is under-gained and tips by design
    return "over 60 degrees" in out


def chk_kf1d(ret, out):
    # 100 steps of u=0.5 → truth 50; prior was wrong (mean 10)
    return abs(float(ret.mean) - 50.0) < 3.0 and float(ret.var) < 2.0


def chk_kf2d(ret, out):
    # deterministic truth after 100 steps: x = 49.5, v = 100
    import numpy as np

    x_est, p = ret
    x = np.asarray(x_est, dtype=np.float64)
    return _finite(x) and abs(x[0] - 49.5) < 5.0 and abs(x[1] - 100.0) < 10.0 \
        and float(np.trace(np.asarray(p))) < 20.0


def chk_est_finite(ret, out):
    return _finite(ret.x) and _finite(ret.p)


# ---- quantitative estimator-ladder checks (VERDICT r4 Next #4) ------------
# The reference's de-facto check is act-vs-est convergence printed per step
# (examples/ukf-pen2.rs:87-103). These predicates make it machine-checked:
# est-vs-truth RMSE over the settled half of the episode, bounded by the
# injected observation noise (and, where the filter robustly beats the raw
# observations on the 20 acceptance seeds, strictly tighter than the
# channel-inverted observations — "the filter earns its keep").
# Margins calibrated over seeds 0-39 (scripts history, r5); the injected
# noise std equals the R diagonal VALUES faithful to the reference (i.e.
# the filter under-states the noise variance — ukf-pen2.rs:56-64).

def _settled_rmse(a, b, lo=50):
    import numpy as np

    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.sqrt(np.mean(d[lo:] ** 2)))


def _enc_k():
    import math

    from mpc_rs_jax.models.params import CartPoleParams

    return 60.0 / (2.0 * math.pi * CartPoleParams.single_wheel().r_w)


def chk_ukf_one(ret, out):
    # scalar UKF, σ_obs = 1: settled est RMSE must beat the raw obs and
    # stay within σ_obs (steady-state KF √P ≈ 0.79; measured max 0.79)
    e = _settled_rmse(ret.est[:, 0], ret.act[:, 0])
    o = _settled_rmse(ret.obs[:, 0], ret.act[:, 0])
    return chk_est_finite(ret, out) and e < o and e <= 1.0


def chk_ukf_two(ret, out):
    # x0 obs noise std 2 (R=2, understated): x0 tracked within the obs
    # band; x1 only observable through the x1⁴ drift term — empirical band
    # (measured max 3.54 over the acceptance seeds)
    e0 = _settled_rmse(ret.est[:, 0], ret.act[:, 0])
    o0 = _settled_rmse(ret.obs[:, 0], ret.act[:, 0])
    e1 = _settled_rmse(ret.est[:, 1], ret.act[:, 1])
    return chk_est_finite(ret, out) and e0 <= 1.2 * o0 and e0 <= 4.0 and e1 <= 5.0


def chk_ukf_pen(ret, out):
    # obs = [dx, dθ] + noise std 0.5: the filter beats the raw channels on
    # every acceptance seed (measured e ≤ 0.49/0.51 vs o ≥ 0.51/0.57)
    e_dx = _settled_rmse(ret.est[:, 1], ret.act[:, 1])
    o_dx = _settled_rmse(ret.obs[:, 0], ret.act[:, 1])
    e_th = _settled_rmse(ret.est[:, 3], ret.act[:, 3])
    o_th = _settled_rmse(ret.obs[:, 1], ret.act[:, 3])
    return (chk_est_finite(ret, out) and e_dx < o_dx and e_th < o_th
            and e_dx <= 0.75 and e_th <= 0.75)


def chk_ukf_pen2(ret, out):
    # obs = [rpm, rpm, deg/s] + noise std [100, 100, 0.5]: gyro-grade dθ
    # tracking (≤1.15× the inverted gyro, ≤0.015 rad/s) and dx within the
    # encoder-inversion band (avg-encoder noise ≈ 0.37 m/s; R understates
    # the injected variance 100× so some seeds trail the inversion —
    # measured max e_dx 0.86, ratio ≤ 2.6)
    import numpy as np

    k = _enc_k()
    dx_o = 0.5 * (ret.obs[:, 0] + ret.obs[:, 1]) / k
    th_o = ret.obs[:, 2] * np.pi / 180.0
    e_dx = _settled_rmse(ret.est[:, 1], ret.act[:, 1])
    o_dx = _settled_rmse(dx_o, ret.act[:, 1])
    e_th = _settled_rmse(ret.est[:, 3], ret.act[:, 3])
    o_th = _settled_rmse(th_o, ret.act[:, 3])
    return (chk_est_finite(ret, out) and e_th <= 1.15 * o_th and e_th <= 0.015
            and e_dx <= 3.0 * o_dx and e_dx <= 1.2)


def chk_ukf_pen3(ret, out):
    # 6-state force-IMU variant: dx earns its keep vs the encoder
    # inversion (measured ratio ≤ 1.24, e_dx ≤ 0.45); dθ is lag-limited by
    # the θ̈-only Q (ukf-pen3.rs:18-25) — absolute band 0.05 rad/s
    import numpy as np

    k = _enc_k()
    dx_o = 0.5 * (ret.obs[:, 0] + ret.obs[:, 1]) / k
    e_dx = _settled_rmse(ret.est[:, 1], ret.act[:, 1])
    o_dx = _settled_rmse(dx_o, ret.act[:, 1])
    e_th = _settled_rmse(ret.est[:, 4], ret.act[:, 4])
    return (chk_est_finite(ret, out) and e_dx <= 1.3 * o_dx and e_dx <= 0.6
            and e_th <= 0.05)


def chk_packets(n_min):
    def chk(ret, out):
        return int(ret) >= n_min

    return chk


def chk_fleet(surv_min):
    def chk(ret, out):
        # last reported cumulative survival line
        vals = [float(ln.split("survival=")[1].split()[0])
                for ln in out.splitlines() if "survival=" in ln]
        return bool(vals) and vals[-1] >= surv_min

    return chk


def chk_serve(ret, out):
    import numpy as np

    return (ret["robots"] == 8 and ret["ticks"] > 5
            and all(n > 0 for n in ret["rx"]) and all(n > 0 for n in ret["tx"])
            and all(th < np.radians(60.0) for th in ret["max_abs_theta"]))


def chk_qp_fleet(park_min):
    def chk(ret, out):
        vals = [float(ln.split("parked=")[1].split()[0])
                for ln in out.splitlines() if "parked=" in ln]
        ups = [float(ln.split("upright=")[1].split()[0])
               for ln in out.splitlines() if "upright=" in ln]
        return bool(vals) and vals[-1] >= park_min and ups[-1] == 1.0

    return chk


def chk_tune(ret, out):
    # ESS of a K-sample softmax lies in [1, K]; derive K from the spec argv
    # so the bound tracks the spec's '--k' instead of a hardcoded constant
    argv = SPECS["tune"][1]
    k = float(argv[argv.index("--k") + 1])
    ref = [c for c in ret if c["lambda"] == 0.5 and c["sigma"] == 3.0]
    return (len(ref) == 1 and ref[0]["survival"] == 1.0
            and ref[0]["mean_cost"] is not None and _finite(ref[0]["mean_cost"])
            and ref[0]["mean_ess"] is not None
            and 1.0 <= ref[0]["mean_ess"] <= k
            and "best cell" in out)


# ---- spec table -----------------------------------------------------------
# (workload, extra argv, check, note). K reduced for CPU where marked; the
# pass criterion itself is the reference's.
SPECS = {
    "mppi2": ("mppi2", [], chk_mppi2, "regulate |x|<0.3 in 5 s (ref K=8000)"),
    "mppi4": ("mppi4", ["--k", "65536"], chk_no_tip60,
              "survive 10 s, no 60° tip (mppi4.rs:50-53); K 65536 for CPU"),
    "mppi4-non-liner": ("mppi4-non-liner", ["--k", "65536"], chk_no_tip60,
                        "survive 10 s, no 60° tip; K 65536 for CPU"),
    "mppi4-non-liner-s": ("mppi4-non-liner-s", ["--k", "16384"], chk_multirate_survives,
                          "multirate loop survives 10 s (UKF in loop)"),
    "mppi4-non-liner-ukf": ("mppi4-non-liner-ukf", ["--k", "16384"], chk_multirate_survives,
                            "flagship survives 10 s incl. 2 N pulse (DEBUG_UKF default)"),
    "mppi4-non-liner-ukf+est": ("mppi4-non-liner-ukf",
                                ["--k", "16384", "--use-ukf-estimate",
                                 "--control-period", "0.02"],
                                chk_multirate_survives,
                                "flagship survives 10 s incl. pulse, ESTIMATOR IN LOOP at the "
                                "(50 Hz, K=16384) operating point validated by the solve-rate "
                                "sweep (SOLVE_RATE_SWEEP.json; survival couples control rate "
                                "with sampling budget — the reference's unthrottled thread is "
                                "~16 Hz at K=5e5)"),
    "op-en2": ("op-en2", [], chk_op_en2, "ball2 optimum found"),
    "op-mpc-x": ("op-mpc-x", [], chk_parks, "parks |x|<0.3, |θ|<0.1, no π/2 bail (op-mpc-x.rs:263-266)"),
    "op-mpc-x-calc": ("op-mpc-x-calc", [], chk_parks, "parks (analytic QP)"),
    "op-mpc-x-calc-nl": ("op-mpc-x-calc-nl", [], chk_parks, "parks under model mismatch"),
    "mpc-ukf-x": ("mpc-ukf-x", [], chk_mpc_ukf_x_faithful,
                  "faithful runaway: θ<π/2 throughout, |x|>10 (proven reference optimum)"),
    "mpc-ukf-s": ("mpc-ukf-s", [], chk_multirate_survives, "QP multirate loop survives incl. pulse"),
    "pid": ("pid", [], chk_pid_tips, "tips at 60° by design (under-gained reference baseline)"),
    "one-liner-kf": ("one-liner-kf", [], chk_kf1d, "recovers from wrong prior to truth ±3"),
    "two-liner-kf": ("two-liner-kf", [], chk_kf2d, "variance contracts, estimate finite"),
    "ukf-one": ("ukf-one", [], chk_ukf_one,
                "settled est RMSE < raw-obs RMSE and ≤ σ_obs=1"),
    "ukf-two": ("ukf-two", [], chk_ukf_two,
                "x0 within 1.2× obs band (σ=2); x1 quartic-channel band ≤5"),
    "ukf-pen": ("ukf-pen", [], chk_ukf_pen,
                "est beats raw [dx, dθ] obs (σ=0.5) on both channels"),
    "ukf-pen2": ("ukf-pen2", [], chk_ukf_pen2,
                 "gyro-grade dθ (≤1.15× inverted gyro, ≤0.015 rad/s); dx within "
                 "encoder-inversion band"),
    "ukf-pen3": ("ukf-pen3", [], chk_ukf_pen3,
                 "dx beats encoder inversion (≤1.3×); dθ ≤0.05 rad/s "
                 "(θ̈-only Q lag; f32-stable UT)"),
    "uart": ("uart", ["--sim-mcu"], chk_packets(1), "COBS echo roundtrip via PTY"),
    "mppi4-commu": ("mppi4-commu", ["--sim-mcu", "--k", "16384", "--t-end", "3"],
                    chk_packets(100), "≥100 packets closed-loop vs fake MCU"),
    "mppi4-ukf-commu": ("mppi4-ukf-commu", ["--sim-mcu", "--k", "8192", "--t-end", "3",
                                            "--time-scale", "0.2"],
                        chk_packets(50), "≥50 Sensor3 packets, no tip (slow-motion HIL twin at 0.2×: CPU "
                        "solve rate meets the scaled 100 Hz deadline; chip_smoke.py runs the full "
                        "K=8e5/N=20 at 1.0× on a GPU)"),
    "mpc-ukf-commu": ("mpc-ukf-commu", ["--sim-mcu", "--t-end", "3", "--time-scale", "0.5"],
                      chk_packets(100), "≥100 packets, QP controller vs fake MCU (0.5× HIL twin)"),
    "fleet-cartpole4": ("fleet", ["--scenarios", "64", "--t-end", "3"], chk_fleet(0.98),
                        "fleet survival ≥0.98 @B=64 (full scale: chip_smoke.py)"),
    "fleet-flagship6": ("fleet", ["--model", "flagship6", "--scenarios", "24", "--t-end", "2",
                                  "--report-every", "2"], chk_fleet(0.90),
                        "flagship fleet survival ≥0.90 @B=24 incl. pulse (full scale: chip_smoke.py)"),
    "serve": ("serve", ["--sim-mcu", "--robots", "8", "--k", "128", "--t-end", "1.0",
                        "--time-scale", "0.2"], chk_serve,
              "serving bridge: 8 PTY robots, one batched solve/tick, every link "
              "gets frames+controls, all upright (0.2× slow-motion twin)"),
    "serve-stream": ("serve", ["--sim-mcu", "--robots", "8", "--k", "128", "--t-end", "1.0",
                               "--time-scale", "0.2", "--ticks-per-dispatch", "2",
                               "--pipeline-depth", "1"], chk_serve,
                     "plan-streaming serve (--ticks-per-dispatch 2): one dispatch per 2 "
                     "ticks, successive plan entries streamed at the tick period; all "
                     "robots served and upright"),
    "tune": ("tune", ["--lambdas", "0.5,1.4", "--sigmas", "3", "--tune-seeds", "2",
                      "--k", "256", "--t-end", "2"], chk_tune,
             "batched sweep: the reference operating point (λ=0.5, σ=3) survives "
             "every episode with finite cost and in-range softmax ESS"),
    "fleet-qp": ("fleet", ["--controller", "qp", "--scenarios", "64", "--t-end", "3"],
                 chk_qp_fleet(0.95),
                 "QP fleet parks ≥0.95 and 100% upright @B=64 in 3 s "
                 "(batched projected-Newton box-QP, nonlinear plant)"),
}


def run_one(name: str, seed: int):
    """Execute one (spec, seed) in-process; returns (passed, detail)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from mpc_rs_jax.apps.run import main as run_main

    workload, extra, check, _ = SPECS[name]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        argv = [workload, "--seed", str(seed), "--log-dir", td] + extra
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                ret = run_main(argv)
            ok = bool(check(ret, buf.getvalue()))
            detail = "" if ok else buf.getvalue()[-300:]
        except Exception:
            ok, detail = False, traceback.format_exc()[-300:]
    return ok, detail, time.perf_counter() - t0


def _worker(item):
    name, seed = item
    ok, detail, dt = run_one(name, seed)
    return name, seed, ok, detail, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--jobs", type=int, default=os.cpu_count())
    ap.add_argument("--only", default=None, help="comma-separated spec names")
    ap.add_argument("--out", default="PARITY_RESULTS.json")
    args = ap.parse_args(argv)

    names = args.only.split(",") if args.only else list(SPECS)
    items = [(n, s) for n in names for s in range(args.seeds)]
    results = {n: {"passes": 0, "seeds": 0, "fails": []} for n in names}

    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with cf.ProcessPoolExecutor(max_workers=args.jobs, mp_context=ctx) as ex:
        for name, seed, ok, detail, dt in ex.map(_worker, items):
            r = results[name]
            r["seeds"] += 1
            r["passes"] += ok
            if not ok:
                r["fails"].append({"seed": seed, "detail": detail})
            print(f"{name:26s} seed {seed:2d} {'PASS' if ok else 'FAIL'} ({dt:5.1f}s)", flush=True)

    out = {}
    for n in names:
        r = results[n]
        out[n] = {
            "criterion": SPECS[n][3],
            "seeds": r["seeds"],
            "passes": r["passes"],
            "rate": round(r["passes"] / max(1, r["seeds"]), 4),
            "fails": r["fails"][:3],
        }
    # --only re-runs merge into an existing results file instead of
    # clobbering the other specs' recorded rates
    merged = out
    if os.path.exists(args.out):
        with open(args.out) as f:
            with contextlib.suppress(Exception):
                merged = json.load(f).get("results", {})
                merged.update(out)
    payload = {"generated_by": "mpc_rs_jax.apps.acceptance", "results": merged}
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps({n: out[n]["rate"] for n in names}, indent=1))
    worst = min(out.values(), key=lambda r: r["rate"])
    print(f"worst rate: {worst['rate']} ({[k for k, v in out.items() if v is worst][0]})")
    return payload


if __name__ == "__main__":
    main()
