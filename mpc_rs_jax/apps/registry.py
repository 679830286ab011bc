"""Example registry: every reference binary → a runner (SURVEY §2c)."""

from __future__ import annotations

from mpc_rs_jax.apps import commu_examples, estimator_examples, fleet as fleet_mod, mpc_examples, mppi_examples, serve as serve_mod, tune as tune_mod

EXAMPLES = {
    # MPPI family
    "mppi2": mppi_examples.mppi2,
    "mppi4": mppi_examples.mppi4,
    "mppi4-non-liner": mppi_examples.mppi4_non_liner,
    "mppi4-non-liner-s": mppi_examples.mppi4_non_liner_s,
    "mppi4-non-liner-ukf": mppi_examples.mppi4_non_liner_ukf,
    # gradient MPC family
    "op-en2": mpc_examples.op_en2,
    "op-mpc-x": mpc_examples.op_mpc_x,
    "op-mpc-x-calc": mpc_examples.op_mpc_x_calc,
    "op-mpc-x-calc-nl": mpc_examples.op_mpc_x_calc_nl,
    "mpc-ukf-x": mpc_examples.mpc_ukf_x,
    "mpc-ukf-s": mpc_examples.mpc_ukf_s,
    # estimators + PID
    "one-liner-kf": estimator_examples.one_liner_kf,
    "two-liner-kf": estimator_examples.two_liner_kf,
    "ukf-one": estimator_examples.ukf_one,
    "ukf-two": estimator_examples.ukf_two,
    "ukf-pen": estimator_examples.ukf_pen,
    "ukf-pen2": estimator_examples.ukf_pen2,
    "ukf-pen3": estimator_examples.ukf_pen3,
    "pid": estimator_examples.pid,
    # hardware-in-the-loop (serial / --sim-mcu)
    "uart": commu_examples.uart,
    "mppi4-commu": commu_examples.mppi4_commu,
    "mppi4-ukf-commu": commu_examples.mppi4_ukf_commu,
    "mpc-ukf-commu": commu_examples.mpc_ukf_commu,
    # op-mpc-tmp.rs is dead code in the reference (SURVEY §2c) — omitted.
    # beyond-parity workloads:
    "fleet": fleet_mod.fleet,  # scenario-fleet north star (BASELINE.json)
    "serve": serve_mod.serve,  # fleet serving bridge: B robot links, one batched solve
    "tune": tune_mod.tune,  # batched (λ, σ)×seeds closed-loop hyperparameter sweep
}


def get_example(name: str):
    if name not in EXAMPLES:
        raise KeyError(f"unknown example {name!r}; choose from {sorted(EXAMPLES)}")
    return EXAMPLES[name]
