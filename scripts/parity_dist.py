"""Distribution-level free-running parity: library vs the native C++ oracle.

VERDICT r4 Next #2 / BASELINE.md item 2: the reference seeds its sampling
from entropy (src/mppi.rs:41), so closed-loop parity with it is inherently
STATISTICAL. The round-4 evidence was matched-noise / per-stage
re-synchronized; this harness adds the complementary statement: N
free-running episodes PER SIDE, each side drawing its OWN noise (library:
jax.random / the fused kernel's counter-based generator; oracle: numpy Generator,
f64), compared as distributions — survival rates (Wilson 95% CIs), and
KS two-sample tests on per-episode θ-RMS and max|θ|.

Workloads (matched configs on both sides; K at the pinned acceptance
operating points — the oracle is single-core C++, so the reference
budgets K=5e5..8e5 run only on the library side, see chip_smoke.py):

- cartpole4     mppi4-non-liner sim loop (deterministic plant, sampling
                noise only): DT=0.1, 10 s, K=16384, λ=0.5, σ=3, ±20,
                x0=(0.5,0,0.1,0), 60° guard. Library: mppi_solve (f32,
                jax.random). [mppi4-non-liner.rs:8-18,81-94]
- flagship-dbg  mppi4-non-liner-ukf with DEBUG_UKF semantics (controller
                sees truth, UKF runs in parallel): the fleet cadence —
                100 Hz, K=8192, T=1.2 N=8, λ=1.4 σ=4 ±10, 2 N pulse
                t∈(1,1.5), R=diag(σ) (σ-as-R quirk), q=gen_q6(2.15·dt),
                10 s, π/2 guard. Library: build_fleet(feed_true_state=True)
                — the full production tier (fused MPPI kernel + SoA UKF on a
                GPU). [mppi4-non-liner-ukf.rs:13-34,224-288]
- flagship-est  same, estimator in loop (controller sees the UKF estimate).
- cartpole4-est the cartpole4 FLEET stack (mppi4-non-liner-s semantics)
                with its UKF(4,3) in the loop at the fleet cadence: 20 Hz
                control (dt=0.05), 5 plant/sensor/UKF substeps at 100 Hz,
                K=1024, λ=0.5 σ=10 ±10, sens=(50,50,0.5) with proper
                R=diag(σ²), Q=gen_q4(0.01) (shared data — gen_q4 itself
                is pinned against reference literals in tests/
                test_models.py), x̂0 = x0, P0=0.1·I, 10 s, 60° guard.
                Seals the second estimator family distributionally.
                [mppi4-non-liner-s.rs:10-21,104-150]
- qp-parking    op-mpc-x-calc-nl (deterministic, model-mismatch): 200
                perturbed initial conditions shared by both sides;
                per-IC parked flags + final-state agreement.
                [op-mpc-x-calc.rs:29-39,73-98 + nonlinear plant]

Usage:
  python scripts/parity_dist.py --config cartpole4 --episodes 200 \
      [--out PARITY_DIST.json]

Each invocation updates one config entry in the output JSON (read-modify-
write), so configs can run separately (fleet configs on a GPU, oracle
sides always on CPU processes).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

N_TICKS_CART = 100     # 10 s at DT=0.1  (mppi4.rs:41)
N_TICKS_FLAG = 1000    # 10 s at 100 Hz
N_TICKS_CART_EST = 200  # 10 s at the 20 Hz fleet cadence
K_CART, K_FLAG = 16384, 8192
K_CART_EST = 1024      # the cartpole4 fleet's per-scenario budget
GUARD_CART, GUARD_FLAG = math.radians(60.0), math.pi / 2


# ---------------------------------------------------------------------------
# oracle-side episodes (pure C++ math via ctypes; own numpy RNG)
# ---------------------------------------------------------------------------

def _oracle_mod():
    import test_native_oracle as tno  # tests/ loader + ctypes wrappers

    return tno


def ep_cartpole4_oracle(seed: int) -> dict:
    tno = _oracle_mod()
    lib = tno.load_oracle()
    r = np.random.default_rng(seed)
    x = np.array([0.5, 0.0, 0.1, 0.0])
    u_n = np.zeros(8)
    thetas = []
    survived = True
    for _ in range(N_TICKS_CART):
        eps = 3.0 * r.standard_normal((K_CART, 8))
        u, st = tno.ora_mppi(lib, 0, 0, x, u_n, eps, 0.5, 3.0, (-20.0, 20.0), 0.1)
        if st != 0:
            u = np.zeros(8)  # the reference's zero-fallback
        u_n = u
        x = tno.ora_dynamics(lib, 0, x, u_n[0], 0.1)
        thetas.append(x[2])
        if abs(x[2]) > GUARD_CART:
            survived = False
            break
    th = np.asarray(thetas)
    return {"survived": survived, "rms_theta": float(np.sqrt(np.mean(th * th))),
            "max_theta": float(np.max(np.abs(th)))}


def ep_flagship_oracle(seed: int, feed_true: bool) -> dict:
    tno = _oracle_mod()
    lib = tno.load_oracle()
    r = np.random.default_rng(seed)
    dt = 0.01
    sens = np.array([200.0, 200.0, 10.0, 0.05, 0.05])
    q = np.empty(36)
    lib.oracle_gen_q6(2.15 * dt, tno._dp(q))
    q = q.reshape(6, 6)
    ukf = tno.OraUkf(lib, np.zeros(6), 0.1 * np.eye(6), q, np.diag(sens),
                     fx_id=1, hx_id=1)
    x = np.zeros(6)
    u_n = np.zeros(8)
    thetas = []
    survived = True
    for i in range(N_TICKS_FLAG):
        src = x if feed_true else ukf.x
        x4 = src[[0, 1, 3, 4]]
        if not np.all(np.isfinite(x4)):
            x4 = np.zeros(4)
        eps = 4.0 * r.standard_normal((K_FLAG, 8))
        u, st = tno.ora_mppi(lib, 2, 1, x4, u_n, eps, 1.4, 4.0, (-10.0, 10.0),
                             1.2 / 8)
        if st != 0:
            u = np.zeros(8)
        u_n = u
        t_now = i * dt
        f = 2.0 if 1.0 < t_now < 1.5 else 0.0  # mppi4-non-liner-ukf.rs:237-247
        x = tno.ora_short6(lib, x, u_n[0], dt, f)
        z = tno.ora_hx(lib, 1, x) + sens * r.standard_normal(5)
        ukf.predict(u_n[0], dt)
        ukf.update(z)
        # mirror ukf_guard (estimators/ukf.py:191): zero non-finite mean
        # entries, reset P — graceful degradation instead of the
        # reference's panic
        if not (np.all(np.isfinite(ukf.x)) and np.all(np.isfinite(ukf.p))):
            ukf.x = np.where(np.isfinite(ukf.x), ukf.x, 0.0)
            ukf.p = 0.1 * np.eye(6)
        thetas.append(x[3])
        if abs(x[3]) > GUARD_FLAG:
            survived = False
            break
    th = np.asarray(thetas)
    return {"survived": survived, "rms_theta": float(np.sqrt(np.mean(th * th))),
            "max_theta": float(np.max(np.abs(th)))}


def _q4_data(dt_sub: float) -> np.ndarray:
    """gen_q4 evaluated in a SHORT-LIVED SUBPROCESS and passed to the
    oracle workers as plain data. Two fork-safety constraints meet here:
    the pool workers are fork()ed, so they must never touch jax (inherited
    XLA thread-pool locks can deadlock) — and the PARENT must not
    initialize jax either, or the subsequent fork() happens from a
    multi-threaded process (same hazard, one level up; a CLI oracle-side
    run is otherwise jax-free by design). Shared DATA: gen_q4's
    transcription is pinned against reference literals in
    tests/test_models.py. If the parent has already initialized jax (the
    CI test / --side both paths), evaluate inline instead — the threads
    exist either way there, and the pool has not forked yet."""
    import subprocess
    import sys as _sys

    if "jax" in _sys.modules:  # already initialized — inline is no worse
        import jax.numpy as jnp

        from mpc_rs_jax.models import noise as noise_mod

        return np.asarray(noise_mod.gen_q4(jnp.float64(dt_sub)), np.float64)
    code = (
        "import jax, json; jax.config.update('jax_platforms','cpu');"
        "import jax.numpy as jnp; import sys; sys.path.insert(0, %r);"
        "from mpc_rs_jax.models import noise;"
        "print(json.dumps(noise.gen_q4(jnp.float64(%r)).tolist()))"
        % (ROOT, dt_sub)
    )
    out = subprocess.run([_sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    return np.asarray(json.loads(out.stdout.strip().splitlines()[-1]),
                      np.float64)


def ep_cartpole4_est_oracle(seed: int, q: np.ndarray) -> dict:
    """Free-running cartpole4 FLEET-stack episode on the C++ oracle:
    20 Hz MPPI on the UKF(4,3) estimate, 5 plant/sensor/filter substeps
    at 100 Hz per tick — mirrors make_scenario_step's cartpole4 wiring
    (parallel/scenario.py rest(); apps/fleet.py cartpole4 branch)."""
    tno = _oracle_mod()
    lib = tno.load_oracle()
    r = np.random.default_rng(seed)
    dt_tick, n_sub = 0.05, 5
    dt_sub = dt_tick / n_sub
    sens = np.array([50.0, 50.0, 0.5])
    x = np.array([0.5, 0.0, 0.1, 0.0])
    ukf = tno.OraUkf(lib, x.copy(), 0.1 * np.eye(4), q, np.diag(sens * sens),
                     fx_id=0, hx_id=0)
    u_n = np.zeros(8)
    thetas = []
    survived = True
    for _ in range(N_TICKS_CART_EST):
        x_ctrl = ukf.x.copy()
        if not np.all(np.isfinite(x_ctrl)):
            x_ctrl = np.zeros(4)
        eps = 10.0 * r.standard_normal((K_CART_EST, 8))
        u, st = tno.ora_mppi(lib, 0, 0, x_ctrl, u_n, eps, 0.5, 10.0,
                             (-10.0, 10.0), 0.1)
        if st != 0:
            u = np.zeros(8)
        u_n = u
        for _s in range(n_sub):
            x = tno.ora_dynamics(lib, 0, x, u_n[0], dt_sub)
            z = tno.ora_hx(lib, 0, x) + sens * r.standard_normal(3)
            ukf.predict(u_n[0], dt_sub)
            ukf.update(z)
            if not (np.all(np.isfinite(ukf.x)) and np.all(np.isfinite(ukf.p))):
                ukf.x = np.where(np.isfinite(ukf.x), ukf.x, 0.0)
                ukf.p = 0.1 * np.eye(4)
        thetas.append(x[2])
        if abs(x[2]) > GUARD_CART:
            survived = False
            break
    th = np.asarray(thetas)
    return {"survived": survived, "rms_theta": float(np.sqrt(np.mean(th * th))),
            "max_theta": float(np.max(np.abs(th)))}


def run_oracle_side(config: str, episodes: int, jobs: int) -> list[dict]:
    import concurrent.futures as cf

    if config == "cartpole4":
        fn, args = ep_cartpole4_oracle, [(2000 + i,) for i in range(episodes)]
    elif config == "flagship-dbg":
        fn, args = ep_flagship_oracle, [(3000 + i, True) for i in range(episodes)]
    elif config == "flagship-est":
        fn, args = ep_flagship_oracle, [(4000 + i, False) for i in range(episodes)]
    elif config == "cartpole4-est":
        q4 = _q4_data(0.05 / 5)
        fn, args = ep_cartpole4_est_oracle, [(5000 + i, q4)
                                             for i in range(episodes)]
    else:
        raise ValueError(config)
    out = []
    with cf.ProcessPoolExecutor(max_workers=jobs) as pool:
        futs = [pool.submit(fn, *a) for a in args]
        for i, f in enumerate(futs):
            out.append(f.result())
            if (i + 1) % 25 == 0:
                print(f"  oracle {i + 1}/{episodes}", flush=True)
    return out


# ---------------------------------------------------------------------------
# library-side episodes
# ---------------------------------------------------------------------------

def run_library_cartpole4(episodes: int) -> list[dict]:
    """Batched free-running episodes of the mppi4-non-liner loop —
    mppi_solve (production f32, jax.random threefry), vmapped over
    episodes, tip-frozen via an alive mask."""
    import jax
    import jax.numpy as jnp

    from mpc_rs_jax.controllers.mppi import MppiConfig, mppi_solve
    from mpc_rs_jax.models import costs, dynamics
    from mpc_rs_jax.models.params import CartPoleParams

    p = CartPoleParams.single_wheel()
    cfg = MppiConfig(n_horizon=8, n_rollouts=K_CART, lambda_=0.5, std_dev=3.0,
                     limit=(-20.0, 20.0))
    step = dynamics.make_cartpole_nonlinear(p, 0.1)

    def one_tick(carry, _):
        x, u_n, key, alive = carry
        key, kk = jax.random.split(key)
        res = mppi_solve(cfg, step, costs.shaped4, kk,
                         tuple(x[i] for i in range(4)), u_n)
        u_new = jnp.where(alive, res.u_n, jnp.zeros_like(res.u_n))
        x_new = jnp.stack(jnp.broadcast_arrays(
            *step(*(x[i] for i in range(4)), u_new[0])))
        x_new = jnp.where(alive, x_new, x)  # freeze tipped episodes
        alive = alive & (jnp.abs(x_new[2]) <= GUARD_CART)
        return (x_new, u_new, key, alive), (x_new[2], alive)

    @jax.jit
    def episode(key):
        x0 = jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32)
        u0 = jnp.zeros(8, jnp.float32)
        carry = (x0, u0, key, jnp.bool_(True))
        _, (thetas, alive) = jax.lax.scan(one_tick, carry, None,
                                          length=N_TICKS_CART)
        return thetas, alive

    keys = jax.random.split(jax.random.key(12345), episodes)
    out = []
    chunk = 25
    for c0 in range(0, episodes, chunk):
        th, al = jax.vmap(episode)(keys[c0:c0 + chunk])
        th, al = np.asarray(th), np.asarray(al)
        for e in range(th.shape[0]):
            # thetas are recorded up to (and including) the tipping tick;
            # after freezing they repeat the final value — mask them out
            n_alive = int(al[e].sum())
            valid = th[e][: n_alive + 1] if n_alive < N_TICKS_CART else th[e]
            out.append({
                "survived": bool(al[e][-1]),
                "rms_theta": float(np.sqrt(np.mean(valid ** 2))),
                "max_theta": float(np.max(np.abs(valid))),
            })
        print(f"  library {min(c0 + chunk, episodes)}/{episodes}", flush=True)
    return out


def run_library_fleet(model: str, k: int, n_ticks: int, episodes: int,
                      feed_true: bool, **fleet_overrides) -> list[dict]:
    """Free-running fleet episodes on the PRODUCTION tier (apps/fleet.py —
    the fused MPPI kernel + SoA UKF on a GPU, the plain path elsewhere),
    one scenario per episode.

    ``fleet_overrides`` forward to build_fleet (sqrt_method=, ukf_layout=,
    backend=, ukf_alpha=) — used to attribute distributional deltas to
    individual tiers."""
    import jax
    import jax.numpy as jnp

    from mpc_rs_jax.apps.fleet import build_fleet
    from mpc_rs_jax.ops import resolve_backend
    from mpc_rs_jax.parallel.mesh import make_mesh

    backend = resolve_backend(fleet_overrides.pop("backend", None))
    b = max(8, ((episodes + 7) // 8) * 8)
    mesh = make_mesh({"scenario": 1, "rollouts": 1})
    tick, carry, dt, theta_idx, guard = build_fleet(
        model, k, backend, mesh, scenarios=b,
        feed_true_state=feed_true,
        **fleet_overrides,
    )

    from functools import partial

    @partial(jax.jit, static_argnames="length")
    def run_chunk(c, length):
        def body(cc, _):
            cc = tick(cc)
            return cc, cc.x[:, theta_idx]

        return jax.lax.scan(body, c, None, length=length)

    # full 50-tick chunks plus an exact remainder chunk, so every caller
    # gets precisely n_ticks ticks (the oracle side runs the same count)
    chunks = [50] * (n_ticks // 50) + ([n_ticks % 50] if n_ticks % 50 else [])
    th_all, done = [], 0
    for length in chunks:
        carry, th = run_chunk(carry, length)
        th_all.append(np.asarray(th))
        done += length
        print(f"  library ticks {done}/{n_ticks}", flush=True)
    th = np.concatenate(th_all, axis=0)  # (N_TICKS, B)

    out = []
    for e in range(episodes):
        t = th[:, e]
        tipped = np.abs(t) > guard
        if tipped.any():
            end = int(np.argmax(tipped)) + 1
            out.append({"survived": False,
                        "rms_theta": float(np.sqrt(np.mean(t[:end] ** 2))),
                        "max_theta": float(np.max(np.abs(t[:end])))})
        else:
            out.append({"survived": True,
                        "rms_theta": float(np.sqrt(np.mean(t * t))),
                        "max_theta": float(np.max(np.abs(t)))})
    return out


def run_library_flagship(episodes: int, feed_true: bool,
                         **fleet_overrides) -> list[dict]:
    """Back-compat wrapper (diag scripts): the flagship fleet config."""
    return run_library_fleet("flagship6", K_FLAG, N_TICKS_FLAG, episodes,
                             feed_true, **fleet_overrides)


# ---------------------------------------------------------------------------
# deterministic QP parking (shared ICs, per-IC comparison)
# ---------------------------------------------------------------------------

def run_qp_parking(episodes: int) -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)  # f64 vs the f64 oracle
    import jax.numpy as jnp

    from mpc_rs_jax.controllers.qp import (active_set_inverse_table,
                                           box_qp_newton, build_condensed_qp,
                                           qp_linear_term)
    from mpc_rs_jax.models import dynamics, reference
    from mpc_rs_jax.models.params import CartPoleParams

    tno = _oracle_mod()
    lib = tno.load_oracle()
    lib.oracle_qp_solve_box.restype = __import__("ctypes").c_int
    lib.oracle_qp_solve_box.argtypes = [tno._D, __import__("ctypes").c_double,
                                        __import__("ctypes").c_double, tno._D]
    sw = CartPoleParams.single_wheel()
    dt = 0.1
    a, bm = dynamics.linear_ab(sw, dt)
    qp = build_condensed_qp(a, bm, np.diag([5.0, 5.0, 1.0, 1.0]), 8)
    gen_ref = reference.make_gen_ref_raised_cosine(8)
    tbl = active_set_inverse_table(qp.h)
    plant = dynamics.make_cartpole_nonlinear(sw, dt)

    r = np.random.default_rng(777)
    base = np.array([0.5, 0.0, 0.1, 0.0])
    ics = base + r.uniform(-0.15, 0.15, size=(episodes, 4))

    @jax.jit
    def lib_tick(x):
        xr = gen_ref(x).reshape(-1)
        bvec = qp_linear_term(qp, x, xr)
        u = box_qp_newton(qp.h, bvec, jnp.zeros(8, jnp.float64),
                          -30.0, 30.0, inv_table=tbl)
        xn = jnp.stack(jnp.broadcast_arrays(*plant(*(x[i] for i in range(4)),
                                                   u[0])))
        return u, xn

    lib_park, ora_park, agree = 0, 0, 0
    max_final_dx = 0.0
    for ic in ics:
        xl = ic.copy()
        xo = ic.copy()
        ok_l = ok_o = True
        for _ in range(60):  # 6 s
            ul, xln = lib_tick(jnp.asarray(xl, jnp.float64))
            xl = np.asarray(xln)
            uo = np.empty(8)
            rc = lib.oracle_qp_solve_box(
                tno._dp(np.ascontiguousarray(xo)), -30.0, 30.0, tno._dp(uo))
            assert rc == 0
            xo = tno.ora_dynamics(lib, 0, xo, uo[0], dt)
            if abs(xl[2]) > math.pi / 2:
                ok_l = False
                break
            if abs(xo[2]) > math.pi / 2:
                ok_o = False
                break
        parked_l = ok_l and abs(xl[0]) < 0.3 and abs(xl[2]) < 0.1
        parked_o = ok_o and abs(xo[0]) < 0.3 and abs(xo[2]) < 0.1
        lib_park += parked_l
        ora_park += parked_o
        agree += parked_l == parked_o
        max_final_dx = max(max_final_dx, float(np.max(np.abs(xl - xo))))
    return {
        "episodes": episodes,
        "library_park_rate": lib_park / episodes,
        "oracle_park_rate": ora_park / episodes,
        "flag_agreement": agree / episodes,
        "max_final_state_diff": max_final_dx,
    }


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------

def wilson(k: int, n: int, z: float = 1.96):
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    d = 1 + z * z / n
    c = p + z * z / (2 * n)
    h = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return ((c - h) / d, (c + h) / d)


def summarize(name: str, lib_eps: list[dict], ora_eps: list[dict]) -> dict:
    from scipy import stats

    out = {"episodes_per_side": len(lib_eps)}
    for side, eps in (("library", lib_eps), ("oracle", ora_eps)):
        surv = sum(e["survived"] for e in eps)
        rms = np.array([e["rms_theta"] for e in eps])
        mx = np.array([e["max_theta"] for e in eps])
        out[side] = {
            "survival": surv / len(eps),
            "survival_wilson95": wilson(surv, len(eps)),
            "rms_theta_mean": float(rms.mean()),
            "rms_theta_std": float(rms.std()),
            "max_theta_mean": float(mx.mean()),
            "max_theta_p99": float(np.quantile(mx, 0.99)),
        }
    lo_l, hi_l = out["library"]["survival_wilson95"]
    lo_o, hi_o = out["oracle"]["survival_wilson95"]
    ks_rms = stats.ks_2samp([e["rms_theta"] for e in lib_eps],
                            [e["rms_theta"] for e in ora_eps])
    ks_max = stats.ks_2samp([e["max_theta"] for e in lib_eps],
                            [e["max_theta"] for e in ora_eps])
    out["tests"] = {
        "survival_ci_overlap": bool(max(lo_l, lo_o) <= min(hi_l, hi_o)),
        "ks_rms_theta": {"stat": float(ks_rms.statistic), "p": float(ks_rms.pvalue)},
        "ks_max_theta": {"stat": float(ks_max.statistic), "p": float(ks_max.pvalue)},
    }
    out["pass"] = bool(out["tests"]["survival_ci_overlap"]
                       and ks_rms.pvalue > 0.01 and ks_max.pvalue > 0.01)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True,
                    choices=["cartpole4", "cartpole4-est", "flagship-dbg",
                             "flagship-est", "qp-parking"])
    ap.add_argument("--episodes", type=int, default=200)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--side", choices=["both", "library", "oracle"],
                    default="both",
                    help="run one side only (results cached in --out under "
                         "<config>.raw.<side>) so the library side can run "
                         "on a GPU in a separate invocation")
    ap.add_argument("--out", default=os.path.join(ROOT, "PARITY_DIST.json"))
    args = ap.parse_args()

    data = {}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            data = json.load(fh)
    entry = data.get(args.config, {})
    raw = entry.get("raw", {})

    t0 = time.time()
    if args.config == "qp-parking":
        entry = run_qp_parking(args.episodes)
        entry["pass"] = bool(entry["flag_agreement"] == 1.0)
    else:
        if args.side in ("both", "library"):
            print(f"[{args.config}] library side ({args.episodes} episodes)",
                  flush=True)
            if args.config == "cartpole4":
                raw["library"] = run_library_cartpole4(args.episodes)
            elif args.config == "cartpole4-est":
                raw["library"] = run_library_fleet(
                    "cartpole4", K_CART_EST, N_TICKS_CART_EST,
                    args.episodes, feed_true=False)
            else:
                raw["library"] = run_library_flagship(
                    args.episodes, feed_true=args.config == "flagship-dbg")
        if args.side in ("both", "oracle"):
            print(f"[{args.config}] oracle side ({args.episodes} episodes)",
                  flush=True)
            raw["oracle"] = run_oracle_side(args.config, args.episodes, args.jobs)
        if "library" in raw and "oracle" in raw:
            entry = summarize(args.config, raw["library"], raw["oracle"])
        entry["raw"] = raw
    entry["seconds"] = round(time.time() - t0, 1)
    data[args.config] = entry
    with open(args.out, "w") as fh:
        json.dump(data, fh, indent=1)
    print(json.dumps({k: v for k, v in entry.items() if k != "raw"}, indent=1))


if __name__ == "__main__":
    main()
