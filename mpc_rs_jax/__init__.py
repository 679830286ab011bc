"""mpc_rs_jax — an MPPI/MPC + UKF real-time control engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
``teruyamato0731/mpc-rs`` Rust crate (reference mounted at /root/reference):

- MPPI sampling controller (reference: src/mppi.rs) as a pure-functional
  ``vmap``/``lax.scan`` solver plus a fused Pallas kernel for NVIDIA GPUs
  with a log-sum-exp reduction (ops/mppi_pallas.py), shardable over a
  ``rollouts`` mesh axis (parallel/).
- Gradient MPC: condensed-QP builders (src/mpc.rs) and a PANOC-style
  box/ball-constrained solver with L-BFGS acceleration
  (controllers/panoc.py) replacing the external ``optimization_engine``.
- UKF estimators for arbitrary state/obs dims (src/ukf.rs, src/ukf2.rs),
  batched over scenarios with ``vmap``; linear KF + scalar Gaussian algebra
  (src/gaussian.rs).
- Deterministic multi-rate closed-loop harness replacing the reference's
  wall-clock thread soup (examples/mppi4-non-liner-ukf.rs).
- Host-side COBS/serial wire protocol (src/packet.rs) with a C++ codec.

Design stance: static shapes under ``jit``, explicit PRNG keys, pure
functions + carried state pytrees, f32 on the GPU with f64-on-CPU oracle mode.
"""

__version__ = "0.1.0"

import jax as _jax

# On the GPU a default-precision f32 dot may run in TF32, which keeps about
# three decimal digits. The engine's dots — the MPPI weighted mean
# (controllers/mppi.py, parallel/sharded_mppi.py), the QP matmuls
# (controllers/qp.py) and the UKF covariance algebra (estimators/ukf.py) —
# are small and not throughput-bound, and TF32 rounding there is lossy, so
# full f32 is the engine-wide default. The fused MPPI kernel has no dot.
_jax.config.update("jax_default_matmul_precision", "highest")

from mpc_rs_jax.controllers.mppi import MppiConfig, MppiStatus, mppi_solve
from mpc_rs_jax.estimators.ukf import UkfParams, UkfState, ukf_init, ukf_predict, ukf_update

__all__ = [
    "MppiConfig",
    "MppiStatus",
    "mppi_solve",
    "UkfParams",
    "UkfState",
    "ukf_init",
    "ukf_predict",
    "ukf_update",
]
