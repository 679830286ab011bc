"""Shared runner plumbing: solver backend choice, guards, printing."""

from __future__ import annotations

import math
import time

import jax
import numpy as np

from mpc_rs_jax.controllers.mppi import MppiConfig, mppi_solve
from mpc_rs_jax.ops import resolve_backend
from mpc_rs_jax.ops.mppi_pallas import mppi_solve_pallas

DEG60 = math.radians(60.0)
PI_2 = math.pi / 2.0


def make_mppi_solver(cfg: MppiConfig, dynamics, cost, n_state: int, backend: str | None = None,
                     *, interpret: bool = False):
    """jitted solve(seed:int, x: np (S,), u_n) -> (u_n, status).

    The fused kernel where it can run (ops.resolve_backend), the plain
    vmap path elsewhere; both keep the same semantics."""
    if resolve_backend(backend, interpret=interpret) == "pallas":

        @jax.jit
        def solve(seed, x, u_n):
            return mppi_solve_pallas(cfg, dynamics, cost, n_state, seed, x, u_n,
                                     interpret=interpret)

        return lambda seed, x, u_n: solve(
            np.int32(seed), np.asarray(x, np.float32), u_n
        )

    @jax.jit
    def solve(key, x, u_n):
        r = mppi_solve(cfg, dynamics, cost, key, tuple(x), u_n)
        return r.u_n, r.status

    return lambda seed, x, u_n: solve(
        jax.random.key(seed) if isinstance(seed, int) else seed,
        np.asarray(x, np.float32),
        u_n,
    )


# Resolved lazily: jax.devices() at import time would initialize every
# backend before callers (tests, the acceptance harness) can choose one.
_CPU_SENTINEL = object()
_CPU = _CPU_SENTINEL


def _cpu_device():
    global _CPU
    if _CPU is _CPU_SENTINEL:
        try:
            _CPU = jax.devices("cpu")[0]
        except RuntimeError:
            _CPU = None
    return _CPU


def host_device():
    """Context manager placing eager jnp ops on the host CPU device (no-op
    when no CPU device is registered). The simulated robot — plant and
    sensor models — lives on the host, beside its serial link."""
    import contextlib

    cpu = _cpu_device()
    return jax.default_device(cpu) if cpu is not None else contextlib.nullcontext()


def np_step(step, x, u, *extra):
    """Apply a component-wise dynamics step to a numpy state vector.

    The plant stands in for the robot, so it runs on the host CPU device:
    one scalar step as eager ops on the accelerator would cost a launch
    per operation."""
    with host_device():
        out = step(*(float(c) for c in x), float(u), *extra)
        return np.array([float(v) for v in out], dtype=np.float64)


class Elapsed:
    def __init__(self):
        self.t0 = time.time()

    def print(self):
        print(f"elapsed: {time.time() - self.t0:.2f} sec")
