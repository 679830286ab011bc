"""Wire-protocol packets — parity with src/packet.rs (zerocopy + COBS).

Little-endian ``struct``-packed layouts matching the Rust ``#[repr(C)]`` /
``#[repr(packed)]`` structs byte-for-byte:

- State   : 4×f32 (x, dx, theta, dtheta)        — src/packet.rs:4-11
- Control : i16                                  — :13-17
- Sensor  : [i16;2] encoder + f32 gyro           — :19-24
- Sensor2 : + [f32;2] accel                      — :26-32
- Sensor3 : packed u8 enable + Sensor2 fields    — :34-41
Each has SIZE, BUF_SIZE = SIZE+2, as_cobs(), from_cobs() (:43-61);
``Control.from_current`` scales ±10 A → ±10000 (:69-76);
``Sensor3.parse`` zeroes disabled channels (:102-121).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from mpc_rs_jax.io.cobs import cobs_decode, cobs_encode


class _CobsPacket:
    _FMT: str  # struct format (little-endian)

    @classmethod
    def size(cls) -> int:
        return struct.calcsize(cls._FMT)

    @classmethod
    def buf_size(cls) -> int:
        return cls.size() + 2

    def _values(self):
        raise NotImplementedError

    def as_cobs(self) -> bytes:
        return cobs_encode(struct.pack(self._FMT, *self._values()))

    @classmethod
    def from_cobs(cls, frame: bytes):
        payload = cobs_decode(frame)
        if len(payload) != cls.size():
            return None
        return cls._from_values(struct.unpack(cls._FMT, payload))

    @classmethod
    def _from_values(cls, vals):
        return cls(*vals)


@dataclasses.dataclass
class State(_CobsPacket):
    x: float
    dx: float
    theta: float
    dtheta: float
    _FMT = "<4f"

    def _values(self):
        return (self.x, self.dx, self.theta, self.dtheta)

    def to_vector(self) -> np.ndarray:
        """From<State> for Vector4 — src/packet.rs:78-82."""
        return np.array([self.x, self.dx, self.theta, self.dtheta], dtype=np.float64)


@dataclasses.dataclass
class Control(_CobsPacket):
    u: int
    _FMT = "<h"
    MAX = 10000

    def _values(self):
        return (self.u,)

    @staticmethod
    def from_current(current: float) -> "Control":
        """±10 A → ±10000 counts — src/packet.rs:69-76 (K = MAX/10; Rust
        ``as i16`` truncates toward zero)."""
        k = Control.MAX / 10.0
        u = int(k * current)  # trunc, like Rust `as`
        u = max(-32768, min(32767, u))
        return Control(u=u)


@dataclasses.dataclass
class Sensor(_CobsPacket):
    encoder0: int
    encoder1: int
    gyro: float
    _FMT = "<2hf"

    def _values(self):
        return (self.encoder0, self.encoder1, self.gyro)

    def to_vector(self) -> np.ndarray:
        return np.array([self.encoder0, self.encoder1, self.gyro], dtype=np.float64)


@dataclasses.dataclass
class Sensor2(_CobsPacket):
    encoder0: int
    encoder1: int
    gyro: float
    accel0: float
    accel1: float
    _FMT = "<2h3f"

    def _values(self):
        return (self.encoder0, self.encoder1, self.gyro, self.accel0, self.accel1)

    def to_vector(self) -> np.ndarray:
        return np.array(
            [self.encoder0, self.encoder1, self.gyro, self.accel0, self.accel1],
            dtype=np.float64,
        )


@dataclasses.dataclass
class Sensor3(_CobsPacket):
    enable: int
    encoder0: int
    encoder1: int
    gyro: float
    accel0: float
    accel1: float
    _FMT = "<B2h3f"  # repr(packed): no padding after the u8

    def _values(self):
        return (self.enable, self.encoder0, self.encoder1, self.gyro, self.accel0, self.accel1)

    def parse(self) -> tuple[int, np.ndarray]:
        """(enable, 5-vector with disabled channels zeroed) — src/packet.rs:102-121."""
        v = np.array(
            [self.encoder0, self.encoder1, self.gyro, self.accel0, self.accel1],
            dtype=np.float64,
        )
        for i in range(5):
            if not (self.enable >> i) & 1:
                v[i] = 0.0
        return self.enable, v
