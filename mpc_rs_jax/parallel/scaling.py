"""Scaling harness: MPPI solves/s vs device count (BASELINE §3).

Measures the K-sharded solve at 1 → n devices on whatever mesh is
available (virtual CPU devices for CI, the GPUs of a host in production —
the code path is identical; multi-host extends via jax.distributed with no
changes here). Reports throughput and parallel efficiency.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from mpc_rs_jax.controllers.mppi import MppiConfig
from mpc_rs_jax.parallel.mesh import make_mesh
from mpc_rs_jax.parallel.sharded_mppi import make_sharded_mppi


def measure_scaling(
    cfg: MppiConfig,
    dynamics,
    cost,
    n_state: int,
    device_counts=None,
    *,
    backend: str = "jnp",
    iters: int = 20,
    x0=None,
    block: int | None = None,
    interpret: bool = False,
) -> list[dict]:
    """Returns [{devices, solves_per_s, efficiency}, ...]; K fixed globally
    so per-device work shrinks as devices grow (strong scaling)."""
    all_devices = jax.devices()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(all_devices)]
    x = jnp.asarray(x0 if x0 is not None else [0.5, 0.0, 0.1, 0.0], jnp.float32)[:n_state]
    u_n = jnp.zeros(cfg.n_horizon, jnp.float32)
    results = []
    base = None
    for nd in device_counts:
        mesh = make_mesh({"rollouts": nd}, devices=all_devices[:nd])
        solve = make_sharded_mppi(
            cfg, dynamics, cost, n_state, mesh,
            backend=backend, block=block, interpret=interpret,
        )
        # inputs vary per iteration but are built BEFORE the timed window
        # so key construction never biases the measurement
        seeds = [jax.random.key(i) if backend == "jnp" else i for i in range(iters + 1)]
        jax.block_until_ready(solve(seeds[0], x, u_n))
        t0 = time.perf_counter()
        for i in range(iters):
            u, st = solve(seeds[i + 1], x, u_n)
        jax.block_until_ready(u)
        sps = iters / (time.perf_counter() - t0)
        if base is None:
            base = sps
        results.append(
            {
                "devices": nd,
                "solves_per_s": sps,
                "speedup": sps / base,
                "efficiency": sps / base / (nd / device_counts[0]),
            }
        )
    return results
