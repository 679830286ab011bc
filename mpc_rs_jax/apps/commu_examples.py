"""Hardware-in-the-loop example runners — parity with examples/*-commu.rs
and uart.rs.

Default device is the robot's serial link (/dev/ttyUSB0 @115200, COBS).
``--sim-mcu`` replaces the robot with a fake MCU thread behind a PTY that
integrates the plant and emits sensor packets — the reference's sim↔HW
twin mechanism (SURVEY §4.3) made executable without hardware.
"""

from __future__ import annotations

import math
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from mpc_rs_jax.apps.common import DEG60, PI_2, Elapsed, host_device, make_mppi_solver, np_step
from mpc_rs_jax.controllers.mppi import MppiConfig
from mpc_rs_jax.controllers.panoc import PanocConfig, box_projection, panoc_solve
from mpc_rs_jax.controllers.qp import build_condensed_qp, make_qp_value_and_grad
from mpc_rs_jax.estimators.ukf import ukf_init, ukf_predict, ukf_update
from mpc_rs_jax.io.cobs import native_available
from mpc_rs_jax.io.packets import Control, Sensor3, State
from mpc_rs_jax.io.serial import PtyPair, SerialPort
from mpc_rs_jax.models import costs, dynamics, noise, observation, reference
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.runtime.logger import CsvLogger


class SimMcu:
    """Fake MCU behind a PTY: integrates the plant at ~1 kHz, replies to
    Control packets, streams State or Sensor3 packets at ``rate_hz``."""

    def __init__(self, mode: str = "state", rate_hz: float = 100.0, seed: int = 0,
                 enable: int = 0b11111, duration: float = 30.0,
                 time_scale: float = 1.0):
        # time_scale < 1 runs the simulated robot in slow motion (sim
        # seconds per wall second): a CI-speed HIL twin for hosts whose
        # solver cannot meet the 100 Hz real-time deadline. The runner must
        # scale its measured packet intervals by the same factor.
        self.pair = PtyPair()
        self.mode = mode
        self.rate = rate_hz
        self.enable = enable
        self.duration = duration
        self.rng = np.random.default_rng(seed)
        self.time_scale = time_scale
        p = CartPoleParams.two_wheel() if mode == "sensor3" else CartPoleParams.single_wheel()
        self.params = p
        if mode == "sensor3":
            # fake-MCU truth plant: the physically-consistent cos(θ)
            # denominator (mpc-ukf-commu.rs:151-166 form); the estimator
            # under test carries each example's own fx variant
            self.plant = dynamics.make_accel6(p, with_force=False)
            self.hx = observation.make_hx_imu6(p)
            self.x = np.zeros(6)
        else:
            self.plant = dynamics.make_cartpole_nonlinear(p, None)
            self.x = np.array([0.0, 0.0, 0.05, 0.0])
        self.u = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @property
    def device(self) -> str:
        return self.pair.slave_path

    def start(self):
        # build/load the native codec now: a first build inside the
        # streaming thread would stall the robot for seconds
        native_available()
        self._thread.start()
        return self

    def _run(self):
        dt = 1e-3
        next_send = 0.0
        t = 0.0
        buf = b""
        t0 = time.time()
        while not self._stop.is_set() and time.time() - t0 < self.duration / self.time_scale:
            # pace physics to wall clock (the robot runs in real time,
            # optionally scaled for slow-motion CI twins)
            ahead = t / self.time_scale - (time.time() - t0)
            if ahead > 0:
                time.sleep(ahead)
            # control in
            data = self.pair.mcu_recv()
            if data:
                buf += data
                while b"\x00" in buf:
                    frame, buf = buf.split(b"\x00", 1)
                    frame += b"\x00"
                    if len(frame) >= Control.buf_size():
                        c = Control.from_cobs(frame[-Control.buf_size():])
                        if c is not None:
                            self.u = c.u / (Control.MAX / 10.0)
            # physics
            if self.mode == "sensor3":
                self.x = np_step(self.plant, self.x, self.u, dt, 0.0)
            else:
                self.x = np_step(self.plant, self.x, self.u, dt)
            t += dt
            # sensor out
            if t >= next_send:
                next_send += 1.0 / self.rate
                if self.mode == "sensor3":
                    with host_device():
                        z = np.array(self.hx(jnp.asarray(self.x, jnp.float32)))
                    z += self.rng.normal(size=5) * [20.0, 20.0, 2.0, 0.05, 0.05]
                    pkt = Sensor3(
                        enable=self.enable,
                        encoder0=int(np.clip(z[0], -32768, 32767)),
                        encoder1=int(np.clip(z[1], -32768, 32767)),
                        gyro=float(z[2]),
                        accel0=float(z[3]),
                        accel1=float(z[4]),
                    )
                else:
                    pkt = State(*(float(v) for v in self.x[:4]))
                try:
                    self.pair.mcu_send(pkt.as_cobs())
                except OSError:
                    break

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        self.pair.close()


def _open_port(args, mode: str, rate=100.0):
    scale = getattr(args, "time_scale", 1.0) or 1.0
    if args.sim_mcu:
        mcu = SimMcu(mode=mode, rate_hz=rate, seed=args.seed, duration=args.t_end + 30,
                     time_scale=scale).start()
        port = SerialPort(mcu.device, 115200, timeout_ms=50)
        return port, mcu
    return SerialPort(args.device, 115200, timeout_ms=10), None


def uart(args):
    """Serial echo smoke test — examples/uart.rs: send Control{1234}, read
    an 18-byte framed State."""
    port, mcu = _open_port(args, "state")
    n_reads = 0
    try:
        deadline = time.time() + min(args.t_end, 5.0)
        while time.time() < deadline:
            port.write_packet(Control(u=1234))
            s = port.read_packet(State)
            if s is not None:
                print(s)
                n_reads += 1
    finally:
        port.close()
        if mcu:
            mcu.stop()
    print(f"received {n_reads} State packets")
    return n_reads


def mppi4_commu(args):
    """HW-in-loop MPPI — examples/mppi4-commu.rs: MCU streams State, host
    replies Control::from_current(u). K=8e5, nonlinear model."""
    p = CartPoleParams.single_wheel()
    t_hor, n = 0.8, 8
    dt = t_hor / n
    k = args.k or 800_000
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=0.5, std_dev=3.0, limit=(-20.0, 20.0))
    step = dynamics.make_cartpole_nonlinear(p, dt)
    solve = make_mppi_solver(cfg, step, costs.shaped4, 4, args.backend)
    u_n = jnp.zeros(n, jnp.float32)
    solve(0, np.zeros(4), u_n)  # pre-compile before real-time traffic starts
    port, mcu = _open_port(args, "state")
    i = 0
    try:
        deadline = time.time() + args.t_end / (getattr(args, 'time_scale', 1.0) or 1.0)
        while time.time() < deadline:
            s = port.read_latest_packet(State)
            if s is None:
                continue
            x = s.to_vector()
            print(f"{x[0]:6.3f} {x[1]:6.3f} {x[2]:6.3f} {x[3]:6.3f} ", end="")
            if x[2] > DEG60:
                print("x[2] is over 60 degrees")
                break
            u_n, status = solve(args.seed + i, x, u_n)
            i += 1
            if int(status) != 0:
                print("Failed to compute ", end="")
                u_n = jnp.zeros(n, jnp.float32)
            print(f"{float(u_n[0]):6.3f}")
            port.write_packet(Control.from_current(float(u_n[0])))
    finally:
        port.close()
        if mcu:
            mcu.stop()
    return i


def mppi4_ukf_commu(args):
    """HW flagship — examples/mppi4-ukf-commu.rs: Sensor3 with enable
    bitmask, UKF2 with per-packet gen_q + gen_r (sensor-dropout R), MPPI
    T=1.2 N=20 K=8e5 λ=2 σ=2."""
    p = CartPoleParams.two_wheel()
    t_hor, n = 1.2, 20
    dt = t_hor / n
    k = args.k or 800_000
    cfg = MppiConfig(n_horizon=n, n_rollouts=k, lambda_=2.0, std_dev=2.0, limit=(-10.0, 10.0))
    ctrl_step = dynamics.make_commu4(p, dt)
    solve = make_mppi_solver(cfg, ctrl_step, costs.commu4, 4, args.backend)
    # UKF fx = this example's own dynamics_short incl. its cos(ẍ)
    # denominator quirk (mppi4-ukf-commu.rs:137-153)
    plant6 = dynamics.make_accel6(p, with_force=False, quirk_denominator=True)
    hx = observation.make_hx_imu6(p)
    r_diag = jnp.asarray([200.0, 200.0, 20.0, 0.5, 0.5], jnp.float32)
    phy = (50.0, 50.0, 10.0)  # mppi4-ukf-commu.rs:28
    params, est = ukf_init(
        jnp.zeros(6, jnp.float32),
        10.0 * jnp.eye(6, dtype=jnp.float32),
        noise.gen_q6(jnp.float32(dt), phy=phy),
        jnp.diag(r_diag),
    )

    @jax.jit
    def est_step(state, u, z, dt_est, enable_mask):
        def fxd(xv, uu):
            out = plant6(*(xv[..., i] for i in range(6)), uu, dt_est, 0.0)
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

        state = state._replace(
            q=noise.gen_q6(dt_est, phy=phy).astype(state.q.dtype),
            r=noise.gen_r_mask(r_diag, enable_mask).astype(state.r.dtype),
        )
        state = ukf_predict(params, state, u, fxd)
        hx_masked = observation.make_masked_hx(hx, enable_mask)
        return ukf_update(params, state, z, hx_masked)

    # pre-compile both hot paths before real-time traffic starts
    solve(0, np.zeros(4), jnp.zeros(n, jnp.float32))
    est_step(est, 0.0, jnp.zeros(5, jnp.float32), jnp.float32(dt), jnp.ones(5, jnp.float32))
    scale = getattr(args, "time_scale", 1.0) or 1.0
    port, mcu = _open_port(args, "sensor3")
    logger = CsvLogger(f"{args.log_dir}/mppi-ukf-com/mppi-ukf-com.csv", timestamped=True)
    u_n = jnp.zeros(n, jnp.float32)
    pre_u = 0.0
    i = 0
    el = Elapsed()
    last_rx = time.time()
    n_rx = 0
    try:
        # the reference spawns its reader/UKF thread BEFORE the control
        # thread (mppi4-ukf-commu.rs:243); wait for the first frame so the
        # controller never acts on the blind init estimate
        first_deadline = time.time() + 5.0
        while time.time() < first_deadline:
            s0 = port.read_latest_packet(Sensor3)
            if s0 is not None:
                enable, z = s0.parse()
                mask = noise.enable_bits_to_mask(enable).astype(jnp.float32)
                est = est_step(est, 0.0, jnp.asarray(z, jnp.float32),
                               jnp.float32(1.0 / 100.0), mask)
                last_rx = time.time()
                break
        deadline = time.time() + args.t_end / (getattr(args, 'time_scale', 1.0) or 1.0)
        while time.time() < deadline:
            s = port.read_latest_packet(Sensor3)
            if s is not None:
                n_rx += 1
                enable, z = s.parse()
                mask = noise.enable_bits_to_mask(enable).astype(jnp.float32)
                dt_est = min(max((time.time() - last_rx) * scale, 1e-4), 0.1)
                last_rx = time.time()
                est = est_step(est, pre_u, jnp.asarray(z, jnp.float32), jnp.float32(dt_est), mask)
                if getattr(args, "console", False):
                    from mpc_rs_jax.runtime.console import print_rcv

                    print_rcv(time.time() - el.t0, pre_u, np.array(est.x), z,
                              p_diag=np.diag(np.array(est.p)))
            xh = np.array(est.x)
            # arm the tip-over guard only once the filter has digested a few
            # packets: with the reference's P0 = 10 I a single noisy first
            # measurement can throw the raw estimate past pi/2 before the
            # covariance contracts (the physical robot boots upright)
            if i > 10 and abs(xh[3]) > PI_2:
                print("x[2] is over pi/2")
                break
            x4 = np.array([xh[0], xh[1], xh[3], xh[4]])
            u_new, status = solve(args.seed + i, x4, u_n)
            i += 1
            if int(status) != 0:
                u_new = jnp.zeros(n, jnp.float32)
            u0 = float(np.clip(float(u_new[0]), -10.0, 10.0))
            if abs(u0 - pre_u) < 1e-2:
                continue  # skip-publish (:85-88)
            pre_u = u0
            u_n = u_new
            port.write_packet(Control.from_current(u0))
            if getattr(args, "console", False):
                from mpc_rs_jax.runtime.console import print_con

                print_con(time.time() - el.t0, u0, [xh[0], xh[1], xh[3], xh[4]])
            logger.write_row(time.time() - el.t0, u0, xh, np.diag(np.array(est.p)))
    finally:
        port.close()
        logger.close()
        if mcu:
            mcu.stop()
    el.print()
    print(f"{i} solves, {n_rx} packets")
    return i


def mpc_ukf_commu(args):
    """HW gradient-MPC flagship — examples/mpc-ukf-commu.rs: N=40 QP PANOC
    (C=diag(0,0,10,3), raised-cosine ref with −0.75 velocity factor),
    Sensor3/gen_r pipeline identical to mppi4-ukf-commu."""
    p = CartPoleParams.two_wheel()
    t_hor, n = 1.2, 40
    dt = t_hor / n
    a, b = dynamics.linear_ab(p, dt, two_wheel=True)
    c = np.diag([0.0, 0.0, 10.0, 3.0])
    qp = build_condensed_qp(a, b, c, n)

    def gen_ref(x):
        # mpc-ukf-commu.rs:192-202: raised cosine with −0.75 velocity factor
        phases = jnp.arange(n) * (math.pi / n)
        r0 = x[0] * (1.0 + jnp.cos(phases)) / 2.0
        r1 = jnp.clip(-0.75 * x[0], -2.0, 2.0) * jnp.sin(phases)
        r2 = jnp.clip(-0.5 * x[0], -0.35, 0.35) * jnp.cos(phases) / 2.0
        r3 = jnp.clip(-0.5 * x[0], -1.5, 1.5) * jnp.sin(phases)
        return jnp.stack([r0, r1, r2, r3], axis=-1)

    vg_factory = make_qp_value_and_grad(qp, gen_ref)
    pcfg = PanocConfig(tol=1e-6, max_iter=args.max_iter or 60, lbfgs_mem=20)
    proj = box_projection(-10.0, 10.0)

    @jax.jit
    def solve(x, u):
        return panoc_solve(pcfg, None, proj, u, value_and_grad=vg_factory(x))

    plant6 = dynamics.make_accel6(p, with_force=False)
    hx = observation.make_hx_imu6(p)
    r_diag = jnp.asarray([200.0, 200.0, 20.0, 0.5, 0.5], jnp.float32)
    params, est = ukf_init(
        jnp.zeros(6, jnp.float32),
        10.0 * jnp.eye(6, dtype=jnp.float32),
        noise.gen_q6(jnp.float32(dt)),
        jnp.diag(r_diag),
    )

    @jax.jit
    def est_step(state, u, z, dt_est, enable_mask):
        def fxd(xv, uu):
            out = plant6(*(xv[..., i] for i in range(6)), uu, dt_est, 0.0)
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

        state = state._replace(
            q=noise.gen_q6(dt_est).astype(state.q.dtype),
            r=noise.gen_r_mask(r_diag, enable_mask).astype(state.r.dtype),
        )
        state = ukf_predict(params, state, u, fxd)
        return ukf_update(params, state, z, observation.make_masked_hx(hx, enable_mask))

    # pre-compile both hot paths before real-time traffic starts
    solve(jnp.zeros(4, jnp.float64), jnp.zeros(n, jnp.float64))
    est_step(est, 0.0, jnp.zeros(5, jnp.float32), jnp.float32(dt), jnp.ones(5, jnp.float32))
    scale = getattr(args, "time_scale", 1.0) or 1.0
    el0 = time.time()
    port, mcu = _open_port(args, "sensor3")
    u_n = jnp.zeros(n, jnp.float64)
    pre_u = 0.0
    i = 0
    last_rx = time.time()
    try:
        # wait for the first frame (see mppi4_ukf_commu)
        first_deadline = time.time() + 5.0
        while time.time() < first_deadline:
            s0 = port.read_latest_packet(Sensor3)
            if s0 is not None:
                enable, z = s0.parse()
                mask = noise.enable_bits_to_mask(enable).astype(jnp.float32)
                est = est_step(est, 0.0, jnp.asarray(z, jnp.float32),
                               jnp.float32(1.0 / 100.0), mask)
                last_rx = time.time()
                break
        deadline = time.time() + args.t_end / (getattr(args, 'time_scale', 1.0) or 1.0)
        while time.time() < deadline:
            s = port.read_latest_packet(Sensor3)
            if s is not None:
                enable, z = s.parse()
                mask = noise.enable_bits_to_mask(enable).astype(jnp.float32)
                dt_est = min(max((time.time() - last_rx) * scale, 1e-4), 0.1)
                last_rx = time.time()
                est = est_step(est, pre_u, jnp.asarray(z, jnp.float32), jnp.float32(dt_est), mask)
                if getattr(args, "console", False):
                    from mpc_rs_jax.runtime.console import print_rcv

                    print_rcv(time.time() - el0, pre_u, np.array(est.x), z,
                              p_diag=np.diag(np.array(est.p)))
            xh = np.array(est.x)
            if i > 10 and abs(xh[3]) > PI_2:  # guard armed after warmup (see mppi4_ukf_commu)
                print("θ is over pi/2")
                break
            x4 = jnp.asarray([xh[0], xh[1], xh[3], xh[4]], jnp.float64)
            res = solve(x4, u_n)
            u_n = res.u
            i += 1
            u0 = float(np.clip(float(u_n[0]), -10.0, 10.0))
            if abs(u0 - pre_u) < 1e-2:
                continue
            pre_u = u0
            port.write_packet(Control.from_current(u0))
            if getattr(args, "console", True):
                from mpc_rs_jax.runtime.console import print_con

                print_con(time.time() - el0, u0, [xh[0], xh[1], xh[3], xh[4]])
    finally:
        port.close()
        if mcu:
            mcu.stop()
    print(f"{i} solves")
    return i
