"""Per-solve timing + XLA profiler hooks.

Replaces the reference's ad-hoc ``Instant`` prints (SURVEY §5: only
wall-clock elapsed, examples/mppi4.rs:39,69) with a structured timer and a
``jax.profiler`` trace context for device traces (TensorBoard/Perfetto).
"""

from __future__ import annotations

import contextlib
import time

import jax
import numpy as np


class SolveTimer:
    """Collects per-call wall times; blocking on device results included."""

    def __init__(self, name: str = "solve"):
        self.name = name
        self.samples_ms: list[float] = []

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.samples_ms.append((time.perf_counter() - t0) * 1e3)

    def wrap(self, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            out = jax.block_until_ready(out)
            self.samples_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        return timed

    def summary(self) -> dict:
        if not self.samples_ms:
            return {"name": self.name, "count": 0}
        a = np.asarray(self.samples_ms)
        return {
            "name": self.name,
            "count": int(a.size),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "p99_ms": float(np.percentile(a, 99)),
            "max_ms": float(a.max()),
        }

    def print_summary(self):
        s = self.summary()
        if s["count"]:
            print(
                f"[{s['name']}] n={s['count']} mean={s['mean_ms']:.3f}ms "
                f"p50={s['p50_ms']:.3f} p95={s['p95_ms']:.3f} p99={s['p99_ms']:.3f} "
                f"max={s['max_ms']:.3f}"
            )


@contextlib.contextmanager
def xla_trace(log_dir: str = "/tmp/mpc_rs_jax_trace"):
    """Capture an XLA device profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
