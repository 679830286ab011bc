"""Serial transport (native termios via libmpcio) + PTY loopback fake.

The reference opens /dev/ttyUSB0 @ 115200 with a 10 ms timeout and frames
on 0x00 (examples/mpc-ukf-commu.rs:38-42, :268-277). ``SerialPort`` is the
host-side equivalent; ``PtyPlant`` is the test seam — a pseudo-terminal
that plays the MCU side, letting the exact HW code path run without a
robot (the sim↔HW twin mechanism of SURVEY §4.3)."""

from __future__ import annotations

import ctypes
import os
import pty
from typing import Optional

from mpc_rs_jax.io.cobs import _load_native


class SerialPort:
    """Raw 8N1 serial port with read-until-0x00 framing."""

    def __init__(self, device: str, baud: int = 115200, timeout_ms: int = 10):
        lib = _load_native()
        if lib is None:
            raise RuntimeError("native mpcio library unavailable (g++ build failed?)")
        self._lib = lib
        self._fd = lib.mpcio_serial_open(device.encode(), baud)
        if self._fd < 0:
            raise OSError(f"cannot open serial device {device}")
        self.timeout_ms = timeout_ms

    def read_frame(self, max_len: int = 256) -> Optional[bytes]:
        """One COBS frame (delimiter included) or None on timeout."""
        buf = (ctypes.c_uint8 * max_len)()
        n = self._lib.mpcio_serial_read_until_zero(self._fd, buf, max_len, self.timeout_ms)
        if n <= 0:
            return None
        data = bytes(buf[:n])
        return data if data.endswith(b"\x00") else None

    def read_packet(self, packet_cls, max_len: int = 256):
        """Frame-resynchronizing packet read — the reference takes the LAST
        BUF_SIZE bytes of the accumulated buffer (mppi4-commu.rs:109-117).

        A frame that fails COBS decode (line noise, partial read after a
        buffer overrun) is DROPPED, not raised: real serial links corrupt
        frames and a control loop must keep running on the next good one.
        Drops are counted in ``n_bad_frames``."""
        data = self.read_frame(max_len)
        if data is None or len(data) < packet_cls.buf_size():
            return None
        try:
            return packet_cls.from_cobs(data[-packet_cls.buf_size():])
        except ValueError:
            self.n_bad_frames = getattr(self, "n_bad_frames", 0) + 1
            return None

    def read_latest_packet(self, packet_cls, max_len: int = 256):
        """Drain the RX queue and parse the newest complete frame. Use when
        the controller is slower than the sensor stream — acting on the
        freshest state instead of a stale queued one (the reference has the
        same staleness hazard via its mpsc queue, mppi4-commu.rs:42-59)."""
        pkt = self.read_packet(packet_cls, max_len)
        if pkt is None:
            return None
        saved_timeout = self.timeout_ms
        self.timeout_ms = 0
        try:
            while True:
                nxt = self.read_packet(packet_cls, max_len)
                if nxt is None:
                    return pkt
                pkt = nxt
        finally:
            self.timeout_ms = saved_timeout

    def write(self, data: bytes) -> int:
        return self._lib.mpcio_serial_write(self._fd, data, len(data))

    def write_packet(self, pkt) -> int:
        return self.write(pkt.as_cobs())

    def close(self):
        if self._fd >= 0:
            self._lib.mpcio_serial_close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PtyPair:
    """A pty master/slave pair: open the slave path as a SerialPort, drive
    the master side as the fake MCU (tests, sim-behind-serial)."""

    def __init__(self):
        self.master_fd, self.slave_fd = pty.openpty()
        os.set_blocking(self.master_fd, False)
        self.slave_path = os.ttyname(self.slave_fd)

    def mcu_send(self, data: bytes):
        os.write(self.master_fd, data)

    def mcu_recv(self, n: int = 256) -> bytes:
        try:
            return os.read(self.master_fd, n)
        except BlockingIOError:
            return b""

    def close(self):
        os.close(self.master_fd)
        os.close(self.slave_fd)
