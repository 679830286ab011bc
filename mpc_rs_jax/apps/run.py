"""CLI entry: ``python -m mpc_rs_jax.apps.run <example> [options]``.

The reference's compile-time ``const`` blocks become flags; defaults match
the cited reference constants per runner.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    from mpc_rs_jax.apps.registry import EXAMPLES

    ap = argparse.ArgumentParser(
        prog="mpc_rs_jax.apps.run",
        description="Run a reference-example workload on the JAX MPC engine.",
    )
    ap.add_argument("example", choices=sorted(EXAMPLES), help="workload name")
    ap.add_argument("--k", type=int, default=None, help="MPPI rollouts (default: reference K)")
    ap.add_argument("--t-end", type=float, default=10.0, help="sim duration [s]")
    ap.add_argument("--seed", type=int, default=0, help="PRNG seed")
    ap.add_argument("--log-dir", default="logs", help="CSV log directory")
    ap.add_argument("--backend", choices=["pallas", "vmap"], default=None,
                    help="MPPI backend (default: the fused kernel on a GPU, vmap elsewhere)")
    ap.add_argument("--max-iter", type=int, default=None, help="PANOC iteration budget")
    ap.add_argument("--fd", action="store_true", help="finite-difference gradients (parity mode)")
    ap.add_argument("--ref-qr", action="store_true",
                    help="use the reference's hand-tuned (rate-fragile) UKF Q/R in mppi4-non-liner-s")
    ap.add_argument("--use-ukf-estimate", action="store_true",
                    help="feed the UKF estimate to the controller (reference DEBUG_UKF=true "
                         "bypasses the estimator; this flag enables the estimator path)")
    ap.add_argument("--device", default="/dev/ttyUSB0", help="serial device for -commu examples")
    ap.add_argument("--console", action="store_true",
                    help="ANSI Con:/Rcv: dual console streams (reference mppi4-non-liner-ukf.rs:291-349)")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="sim seconds per wall second for --sim-mcu (slow-motion HIL twin, <1 for slow hosts)")
    ap.add_argument("--sim-mcu", action="store_true",
                    help="replace the robot with a fake MCU behind a PTY")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--scenarios", type=int, default=1024, help="fleet batch size")
    ap.add_argument("--report-every", type=float, default=1.0, help="fleet report period [s]")
    ap.add_argument("--resume", default=None, help="fleet checkpoint to resume from "
                    "(.npz file or orbax directory; backend inferred)")
    ap.add_argument("--ckpt-backend", choices=["npz", "orbax"], default="npz",
                    help="fleet checkpoint format: single .npz (default) or orbax "
                    "(atomic commit, sharded-array placement preserved)")
    ap.add_argument("--controller", choices=["mppi", "qp"], default="mppi",
                    help="fleet controller: sampling MPPI or batched gradient-MPC (condensed QP)")
    ap.add_argument("--qp-solver", choices=["newton", "panoc"], default="newton",
                    help="QP-fleet solver: batched projected Newton (exact KKT, lane-dense, "
                         "default) or the general vmapped PANOC path")
    ap.add_argument("--model", choices=["cartpole4", "flagship6"], default="cartpole4",
                    help="fleet plant/estimator stack")
    ap.add_argument("--sqrt-method", choices=["eigh", "jacobi", "cholesky"], default=None,
                    help="override the fleet UKF sigma-root (default: per-model choice)")
    ap.add_argument("--ukf-alpha", type=float, default=None,
                    help="override the UKF sigma-point spread α (fleet and "
                         "mppi4-non-liner-ukf). Defaults: fleet tiers and the "
                         "flagship's --use-ukf-estimate mode use 1.0 (the "
                         "f32-conditioned Julier set); the flagship's DEBUG_UKF "
                         "mode keeps the reference's Merwe 1e-3, which in f32 "
                         "amplifies sigma-point rounding ~1.7e5× into the "
                         "predicted mean (DESIGN §18)")
    ap.add_argument("--ukf-layout", choices=["soa", "aos"], default=None,
                    help="fleet estimator layout: batch-minor SoA (lane-dense, default) "
                         "or the vmapped AoS reference path")
    ap.add_argument("--lambdas", default="0.1,0.5,1.4,2.5",
                    help="tune: comma-separated MPPI λ grid")
    ap.add_argument("--sigmas", default="1,3,10",
                    help="tune: comma-separated MPPI σ grid")
    ap.add_argument("--tune-seeds", type=int, default=8,
                    help="tune: episodes (seeds) per grid cell")
    ap.add_argument("--robots", type=int, default=8,
                    help="serve: number of robot links")
    ap.add_argument("--stale-timeout", type=float, default=0.5,
                    help="serve: seconds without a frame before a robot gets zero control")
    ap.add_argument("--pipeline-depth", type=int, default=0,
                    help="serve: batched solves kept in flight (0 = synchronous). Each "
                         "level hides one dispatch behind the control period at the "
                         "cost of one period of extra control latency")
    ap.add_argument("--ticks-per-dispatch", type=int, default=1,
                    help="serve: stream the first M entries of each returned plan at "
                         "successive control ticks (plan steps re-discretized to the "
                         "tick period), dispatching only every M ticks, at the cost of "
                         "entries 1..M-1 executing open-loop (M=1 = the reference's "
                         "freshest-state-wins posture)")
    ap.add_argument("--control-period", type=float, default=None,
                    help="controller period [s] for the multirate loops; 0 = free-running "
                         "(tick every phys step, the reference's unthrottled control thread). "
                         "The reference's effective rate is its solve latency: K=5e5 at its "
                         "64 M steps/s CPU baseline is ~16 Hz (BASELINE.md)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from mpc_rs_jax.runtime.cache import enable_compile_cache

    enable_compile_cache()
    from mpc_rs_jax.apps.registry import get_example

    return get_example(args.example)(args)


if __name__ == "__main__":
    main()
