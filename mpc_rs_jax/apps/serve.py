"""Fleet serving bridge: many robot links, one device, one batched solve.

The reference binds ONE robot per process (examples/mppi4-commu.rs:
/dev/ttyUSB0 → MPPI → Control), which leaves an accelerator almost idle.
This runner multiplexes B COBS serial links into ONE scenario-batched
kernel call per control tick — the serving pattern for robot fleets:

    robot i ──COBS State──▶ reader thread ──▶ latest-state table ─┐
    robot j ──COBS State──▶ reader thread ──▶ latest-state table ─┤
                                                                  ▼
                                        mppi_solve_pallas_batch (B, …)
                                                                  │
    robot i ◀──COBS Control(u0_i)──── control tick ◀──────────────┘

Per-robot semantics match mppi4-commu.rs exactly: freshest State wins
(the reference's mpsc-drain staleness posture, examples/mppi4-commu.rs:
42-59), warm-started u_n per robot, zero-control on solver failure
(examples/mppi4-ukf-commu.rs:76-81), Control::from_current scaling out
(src/packet.rs:69-76). A link that goes quiet for ``--stale-timeout``
seconds gets zero control (the reference's failure posture) until it
resumes; the batched solve keeps serving the rest of the fleet.

Robot links are serial devices (``--device /dev/ttyUSB0,/dev/ttyUSB1,…``)
or ``--sim-mcu`` PTY fake MCUs (one simulated robot per link — the HIL
twin seam of SURVEY §4.3 at fleet scale).
"""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from mpc_rs_jax.apps.commu_examples import SimMcu
from mpc_rs_jax.apps.common import DEG60
from mpc_rs_jax.controllers.mppi import MppiConfig, mppi_solve
from mpc_rs_jax.io.packets import Control, State
from mpc_rs_jax.io.serial import SerialPort
from mpc_rs_jax.models import costs, dynamics
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.ops import resolve_backend
from mpc_rs_jax.ops.mppi_pallas import mppi_solve_pallas_batch


def make_batch_solver(cfg: MppiConfig, step, cost, n_state: int,
                      backend: str | None = None, *, interpret: bool = False):
    """jitted ``solve(seeds (B,), xs (B,S), u_ns (B,N)) ->
    (u_ns' (B,N), u0 (B,), statuses)`` — all returned lazily (device
    arrays), so the caller can pipeline dispatches.

    The per-robot zero fallback (examples/mppi4-ukf-commu.rs:76-81) is
    applied IN-JIT: a failed solve's whole sequence is zeroed before it
    becomes the next warm start, and the warm-start chain stays
    device-resident — the host only ever reads back the (B,) u0 column.

    The scenario-batched fused kernel (one launch for the whole fleet)
    where it can run (ops.resolve_backend), else the vmapped reference
    path (identical semantics)."""
    if resolve_backend(backend, interpret=interpret) == "pallas":

        def raw(seeds, xs, u_ns):
            return mppi_solve_pallas_batch(cfg, step, cost, n_state, seeds, xs, u_ns,
                                           interpret=interpret)

    else:

        def raw(seeds, xs, u_ns):
            keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.key(0), seeds)

            def one(key, x, u_n):
                r = mppi_solve(cfg, step, cost, key,
                               tuple(x[i] for i in range(n_state)), u_n)
                return r.u_n, r.status

            return jax.vmap(one)(keys, xs, u_ns)

    @jax.jit
    def solve(seeds, xs, u_ns):
        u, st = raw(seeds, xs, u_ns)
        u = jnp.where((st != 0)[:, None], 0.0, u)  # zero fallback, per robot
        return u, u[:, 0], st

    # np.array(..., copy=True): on CPU backends jnp.asarray can alias a
    # same-dtype numpy buffer zero-copy, and the caller's preallocated
    # state table is mutated in place on the NEXT tick while a pipelined
    # (async) solve may still be reading this one's input.
    return lambda seeds, xs, u_ns: solve(
        jnp.asarray(np.array(seeds, np.int32)),
        jnp.asarray(np.array(xs, np.float32)),
        u_ns,
    )


class RobotLink:
    """One robot's serial link + reader thread maintaining the freshest
    State (the reference's reader-thread → mpsc channel, batched:
    examples/mppi4-commu.rs:42-50)."""

    def __init__(self, index: int, port: SerialPort, mcu: SimMcu | None = None):
        self.index = index
        self.port = port
        self.mcu = mcu
        self.x = np.zeros(4, np.float64)
        self.last_rx = -1.0  # wall time of last good frame (-1 = never)
        self.n_rx = 0
        self.n_tx = 0
        self.max_abs_theta = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._reader, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _reader(self):
        while not self._stop.is_set():
            s = self.port.read_latest_packet(State)
            if s is None:
                continue
            x = s.to_vector()
            with self._lock:
                self.x = x
                self.last_rx = time.time()
                self.n_rx += 1
                self.max_abs_theta = max(self.max_abs_theta, abs(float(x[2])))

    def snapshot(self):
        with self._lock:
            return self.x, self.last_rx

    def send(self, current: float):
        try:
            self.port.write_packet(Control.from_current(current))
            self.n_tx += 1
        except OSError:
            pass  # link gone; staleness will zero it out

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        self.port.close()
        if self.mcu:
            self.mcu.stop()


def _open_links(args, b: int):
    links = []
    if args.sim_mcu:
        scale = getattr(args, "time_scale", 1.0) or 1.0
        for i in range(b):
            mcu = SimMcu(mode="state", rate_hz=100.0, seed=args.seed + i,
                         duration=args.t_end + 30, time_scale=scale).start()
            port = SerialPort(mcu.device, 115200, timeout_ms=20)
            links.append(RobotLink(i, port, mcu).start())
    else:
        devices = [d for d in args.device.split(",") if d]
        if len(devices) != b:
            raise ValueError(
                f"--robots {b} but --device lists {len(devices)} links; "
                "pass a comma-separated device per robot"
            )
        for i, dev in enumerate(devices):
            links.append(RobotLink(i, SerialPort(dev, 115200, timeout_ms=20)).start())
    return links


def serve(args):
    """Serve a robot fleet from one device: B links, one batched solve/tick.

    Controller per robot = the mppi4-commu stack (nonlinear cart-pole,
    T=0.8 N=8, σ=3, limit ±20 — examples/mppi4-commu.rs:8-19) at a
    fleet-appropriate default K (--k overrides; the reference's K=8e5 is
    a single-robot budget)."""
    b = args.robots
    p = CartPoleParams.single_wheel()
    t_hor, n = 0.8, 8
    scale = getattr(args, "time_scale", 1.0) or 1.0
    period_sim = args.control_period if args.control_period else 0.01
    m_stream = max(1, int(getattr(args, "ticks_per_dispatch", 1) or 1))
    if m_stream > 1:
        # Multi-tick plan streaming: one dispatch returns a PLAN whose
        # steps are re-discretized to the tick period, and the host streams
        # its first M entries at successive ticks, so the dispatch path
        # carries only tick_rate/M solves. Cost: entries j=1..M−1 are
        # open-loop (computed from a state j ticks stale) — the standard
        # plan-execution trade; the reference's freshest-state-wins
        # posture is M=1 (examples/mppi4-commu.rs:42-59).
        dt = period_sim
        n = int(np.clip(round(t_hor / dt), max(8, m_stream), 40))
    else:
        dt = t_hor / n
    k = args.k or 8192
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=0.5, std_dev=3.0,
                     limit=(-20.0, 20.0))
    step = dynamics.make_cartpole_nonlinear(p, dt)
    solve = make_batch_solver(cfg, step, costs.shaped4, 4, args.backend)

    xs = np.zeros((b, 4), np.float32)
    u_dev = jnp.zeros((b, n), jnp.float32)
    seeds0 = np.arange(b, dtype=np.int32)
    # pre-compile before real-time traffic starts (mppi4-commu.rs posture)
    u_out, _, _ = solve(seeds0, xs, u_dev)
    np.asarray(u_out)

    period = period_sim / scale
    stale = args.stale_timeout / scale
    # Pipelined dispatch (depth-D double buffering): jax dispatch is async,
    # so D batched solves are in flight at once and the host blocks only
    # on the OLDEST result's (B,) u0 readback. The warm-start chain
    # (u_n of solve t feeds solve t+1) never leaves the device. Controls
    # sent at tick t were computed from tick t−D's states: D extra periods
    # of control latency traded for throughput that hides dispatch time — the
    # reference's freshest-state-wins posture at depth 0
    # (examples/mppi4-commu.rs:42-59), relaxed by D ticks when pipelining.
    depth = max(0, int(getattr(args, "pipeline_depth", 0) or 0))
    from collections import deque

    pending = deque()
    links = _open_links(args, b)

    ticks = 0
    solve_s = []
    t0 = time.time()
    next_report = t0 + args.report_every
    deadline = t0 + args.t_end / scale
    dispatched = 0
    last_fresh = np.zeros(b, bool)

    def dispatch():
        """Snapshot freshest states and launch one async batched solve."""
        nonlocal u_dev, dispatched
        snap_t = time.time()
        fresh = np.zeros(b, bool)
        for ln in links:
            x, last_rx = ln.snapshot()
            xs[ln.index] = x
            fresh[ln.index] = last_rx > 0 and (snap_t - last_rx) < stale
        last_fresh[:] = fresh
        if not fresh.any():
            return False
        seeds = np.int32(args.seed) + np.int32(dispatched) * b + seeds0
        u_dev, u0_dev, _st = solve(seeds, xs, u_dev)
        dispatched += 1
        pending.append(
            (time.time(), u_dev if m_stream > 1 else u0_dev, fresh.copy()))
        return True

    def pop_plan():
        s0, u_plan_dev, fr = pending.popleft()
        u_plan = np.asarray(u_plan_dev)  # blocks until this solve lands
        solve_s.append(time.time() - s0)
        if u_plan.ndim == 1:
            u_plan = u_plan[:, None]
        return u_plan, fr

    plan, plan_fresh, plan_j = None, None, m_stream

    try:
        while time.time() < deadline:
            tick_t0 = time.time()
            if plan_j >= m_stream or plan is None:
                # plan exhausted: keep `depth` extra dispatches in flight
                # beyond the one we are about to consume, then block on the
                # oldest. (Entries j=1..M−1 of the popped plan are
                # executed open-loop at the following ticks.)
                if not pending:
                    dispatch()
                while pending and len(pending) <= depth:
                    if not dispatch():
                        break
                if pending:
                    plan, plan_fresh = pop_plan()
                    plan_j = 0
            if plan is not None and plan_j < plan.shape[1]:
                for ln in links:
                    i = ln.index
                    ln.send(float(plan[i, plan_j]) if plan_fresh[i] else 0.0)
                ticks += 1
                plan_j += 1
            now = time.time()
            if now >= next_report:
                next_report += args.report_every
                el = now - t0
                med = 1e3 * float(np.median(solve_s[-200:])) if solve_s else 0.0
                print(
                    f"[serve] t={el * scale:6.2f}s ticks/s={ticks / el:7.1f} "
                    f"solves/s={dispatched / el:6.1f} "
                    f"active={int(last_fresh.sum())}/{b} depth={len(pending)} "
                    f"solve_ms={med:6.2f} "
                    f"rx={sum(ln.n_rx for ln in links)} "
                    f"bad={sum(getattr(ln.port, 'n_bad_frames', 0) for ln in links)}"
                )
            ahead = (tick_t0 + period) - time.time()
            if ahead > 0:
                time.sleep(ahead)
        while pending:
            pending.popleft()  # drain without sending past the deadline
    finally:
        for ln in links:
            ln.stop()

    el = time.time() - t0
    summary = {
        "robots": b,
        "ticks": ticks,
        "ticks_per_s": ticks / el,
        "dispatches": dispatched,
        "dispatches_per_s": dispatched / el,
        "ticks_per_dispatch": m_stream,
        "plan_dt": dt,
        "horizon": n,
        "robot_solves_per_s": ticks * b / el,
        "rx": [ln.n_rx for ln in links],
        "tx": [ln.n_tx for ln in links],
        "max_abs_theta": [ln.max_abs_theta for ln in links],
        "solve_ms_p50": 1e3 * float(np.median(solve_s)) if solve_s else 0.0,
        "bad_frames": sum(getattr(ln.port, "n_bad_frames", 0) for ln in links),
    }
    survived = sum(1 for th in summary["max_abs_theta"] if th < DEG60)
    print(
        f"[serve] done: {ticks} ticks, {summary['robot_solves_per_s']:.0f} "
        f"robot-solves/s, {survived}/{b} robots upright "
        f"(solve p50 {summary['solve_ms_p50']:.2f} ms)"
    )
    return summary
