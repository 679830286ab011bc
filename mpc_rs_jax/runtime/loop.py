"""Deterministic closed-loop harnesses.

Replaces the reference's wall-clock thread topology (4 threads +
``Arc<Mutex>``, examples/mppi4-non-liner-ukf.rs:224-288 — SURVEY §3.4) with
a deterministic multi-rate tick loop: physics at dt_phys, sensor at its own
period plus a fixed latency, controller and logger at theirs, disturbance
windows in *sim-time* (not wall clock). Same behavior class, reproducible.

Two harnesses:
- ``run_simple_loop``  — the single-rate open-loop examples
  (mppi4.rs:41-67: solve → step → log → tip-over guard).
- ``run_multirate_loop`` — the threaded sim examples (mppi4-non-liner-ukf,
  mpc-ukf-s): pluggable plant/estimator/controller closures.

The "plant" seam is a pure function here (SimPlant); the serial-HW plant
(mpc_rs_jax.io) plugs into the same loop by replacing ``plant_step`` and
``sensor`` with packet I/O — the reference's sim↔HW twin structure
(SURVEY §4.3) as a first-class seam.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import numpy as np


@dataclasses.dataclass(frozen=True)
class MultiRateConfig:
    dt_phys: float = 1e-3  # physics tick
    sensor_period: float = 9e-3  # UKF thread cadence (sleep 9 ms — :268)
    sensor_latency: float = 0.0  # observation age (modeled, not slept)
    # controller cadence; None = FREE-RUNNING: re-solve every physics tick,
    # like the reference's unthrottled control threads (no sleep in the loop,
    # mppi4-non-liner-ukf.rs:54-99) on an infinitely fast solver
    control_period: Optional[float] = 1e-2
    log_period: float = 30e-3  # logging thread cadence (:403)
    t_end: float = 10.0
    skip_publish_eps: float = 1e-2  # |Δu|<ε ⇒ skip publish (:88-90)
    disturbance: Optional[Callable[[float], float]] = None  # f(t) [N] (:237-244)
    tip_over: Optional[Callable[[np.ndarray], bool]] = None  # episode guard


class LoopResult(NamedTuple):
    t: float
    x: np.ndarray
    tipped: bool
    n_solves: int
    history: list


def pulse_disturbance(t0: float = 1.0, t1: float = 1.5, f: float = 2.0):
    """The reference's push: f N during t∈(t0,t1) s — mppi4-non-liner-ukf.rs:237-244."""
    return lambda t: f if t0 < t < t1 else 0.0


def run_simple_loop(
    *,
    solve: Callable,  # (key, x, u_n) -> (u_n', status)
    plant_step: Callable,  # (x, u) -> x  (np arrays)
    dt: float,
    t_end: float,
    x0: np.ndarray,
    u0: np.ndarray,
    key,
    tip_over: Optional[Callable] = None,
    logger=None,
    on_step: Optional[Callable] = None,
) -> LoopResult:
    """Single-rate loop of the open-loop examples (mppi4.rs:41-67)."""
    x = np.asarray(x0, dtype=np.float64)
    u_n = u0
    t = 0.0
    n = 0
    hist = []
    tipped = False
    while t < t_end:
        key, sub = jax.random.split(key)
        u_n, status = solve(sub, x, u_n)
        if int(status) != 0:
            # caller-side zero fallback is already inside solve
            pass
        u0_now = float(u_n[0])
        x = np.asarray(plant_step(x, u0_now), dtype=np.float64)
        n += 1
        hist.append((t, u0_now, x.copy()))
        if logger is not None:
            logger.write_row(t, u0_now, x)
        if on_step is not None:
            on_step(t, u0_now, x)
        if tip_over is not None and tip_over(x):
            tipped = True
            break
        t += dt
    return LoopResult(t=t, x=x, tipped=tipped, n_solves=n, history=hist)


def run_multirate_loop(
    cfg: MultiRateConfig,
    *,
    plant_step: Callable,  # (x, u, dt, f) -> x           (np arrays)
    sensor: Callable,  # (rng, x) -> z                 (np arrays)
    est_predict_update: Callable,  # (est, u, z, dt) -> est
    est_state: Callable,  # (est) -> np x_hat
    controller: Callable,  # (key, x_hat, u_n) -> (u_n', status)
    predictor: Optional[Callable],  # (x_hat, u_n) -> x_pred  (N-step, logging)
    x0: np.ndarray,
    u0,
    est0,
    key,
    rng: np.random.Generator,
    logger=None,
    debug_ukf_bypass: bool = False,  # DEBUG_UKF: controller sees true state (:30-31)
) -> LoopResult:
    """Deterministic multi-rate closed loop (flagship sim topology §3.4).

    Controller runs every ``control_period`` reading the latest estimate;
    estimator runs every ``sensor_period`` on an observation that is
    ``sensor_latency`` old; physics every ``dt_phys``; CSV every
    ``log_period`` with the N-step forward prediction
    (mppi4-non-liner-ukf.rs:419-422).
    """
    x = np.asarray(x0, dtype=np.float64)
    u_n = u0
    est = est0
    t = 0.0
    n_solves = 0
    hist = []
    tipped = False

    lat_steps = max(0, int(round(cfg.sensor_latency / cfg.dt_phys)))
    x_hist = [x.copy()] * (lat_steps + 1)

    next_sensor = cfg.sensor_period
    next_control = 0.0
    next_log = 0.0
    last_est_t = 0.0

    free_run = cfg.control_period is None
    while t < cfg.t_end:
        # --- controller tick
        if free_run or t >= next_control:
            x_hat = x.copy() if debug_ukf_bypass else est_state(est)
            if cfg.tip_over is not None and cfg.tip_over(x_hat):
                tipped = True
                break
            key, sub = jax.random.split(key)
            u_new, status = controller(sub, x_hat, u_n)
            n_solves += 1
            if abs(float(u_new[0]) - float(u_n[0])) >= cfg.skip_publish_eps or n_solves == 1:
                u_n = u_new  # publish (skip-if-close: :88-90,351-354)
            if not free_run:
                next_control += cfg.control_period

        # --- physics tick
        f = cfg.disturbance(t) if cfg.disturbance is not None else 0.0
        x = np.asarray(plant_step(x, float(u_n[0]), cfg.dt_phys, f), dtype=np.float64)
        x_hist.append(x.copy())
        if len(x_hist) > lat_steps + 1:
            x_hist.pop(0)

        # --- sensor/estimator tick
        if t >= next_sensor:
            z = sensor(rng, x_hist[0])  # delayed observation
            dt_est = t - last_est_t if last_est_t > 0 else cfg.sensor_period
            est = est_predict_update(est, float(u_n[0]), z, dt_est)
            last_est_t = t
            next_sensor += cfg.sensor_period

        # --- logging tick
        if logger is not None and t >= next_log:
            x_hat = est_state(est)
            x_pred = predictor(x_hat, u_n) if predictor is not None else x_hat
            logger.write_row(t, float(u_n[0]), x, x_hat, x_pred)
            next_log += cfg.log_period

        hist.append((t, float(u_n[0])))
        t += cfg.dt_phys

    return LoopResult(t=t, x=x, tipped=tipped, n_solves=n_solves, history=hist)
