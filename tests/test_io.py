"""COBS codec (native C++ vs Python), packets, serial-over-PTY loopback."""

import struct

import numpy as np
import pytest

from mpc_rs_jax.io.cobs import (
    _py_cobs_decode,
    _py_cobs_encode,
    cobs_decode,
    cobs_encode,
    native_available,
)
from mpc_rs_jax.io.packets import Control, Sensor, Sensor2, Sensor3, State


def test_native_builds():
    assert native_available(), "g++ build of native/mpcio.cpp failed"


@pytest.mark.parametrize(
    "payload",
    [
        b"",
        b"\x00",
        b"\x11\x22\x00\x33",
        b"\x11\x22\x33\x44",
        b"\x00" * 10,
        bytes(range(1, 100)),
        bytes(300 % (i + 1) for i in range(254)),  # long run crossing 0xFF code
        bytes([1]) * 300,
    ],
)
def test_cobs_roundtrip_native_and_python_agree(payload):
    enc_py = _py_cobs_encode(payload)
    assert _py_cobs_decode(enc_py) == payload
    if native_available():
        enc_c = cobs_encode(payload, use_native=True)
        assert enc_c == enc_py, "native and python COBS encoders disagree"
        assert cobs_decode(enc_c, use_native=True) == payload


def test_cobs_overhead_matches_reference_buf_size():
    # BUF_SIZE = SIZE + 2 for all reference packets (src/packet.rs:46-47)
    for size in (2, 8, 16, 17):
        assert len(cobs_encode(b"\x01" * size)) == size + 2
        assert len(cobs_encode(b"\x00" * size)) == size + 2


def test_packet_sizes_match_rust_layout():
    assert State.size() == 16 and State.buf_size() == 18  # uart.rs:22 reads 18
    assert Control.size() == 2
    assert Sensor.size() == 8
    assert Sensor2.size() == 16
    assert Sensor3.size() == 17  # repr(packed): 1 + 2*2 + 3*4


def test_state_roundtrip():
    s = State(x=1.5, dx=-0.25, theta=0.125, dtheta=3.0)
    s2 = State.from_cobs(s.as_cobs())
    assert s2 == s
    np.testing.assert_allclose(s2.to_vector(), [1.5, -0.25, 0.125, 3.0])


def test_control_from_current():
    # K = 10000/10 (src/packet.rs:70-73); Rust `as i16` truncates
    assert Control.from_current(1.234).u == 1234
    assert Control.from_current(-9.9996).u == -9999
    assert Control.from_current(10.0).u == 10000
    c = Control.from_current(5.5)
    assert Control.from_cobs(c.as_cobs()).u == 5500


def test_sensor3_parse_enable_mask():
    s = Sensor3(enable=0b01011, encoder0=100, encoder1=-50, gyro=2.5, accel0=0.1, accel1=-0.2)
    enable, v = Sensor3.from_cobs(s.as_cobs()).parse()
    assert enable == 0b01011
    np.testing.assert_allclose(v, [100.0, -50.0, 0.0, 0.099999994, 0.0], rtol=1e-6)


def test_sensor3_packed_layout():
    s = Sensor3(enable=7, encoder0=1, encoder1=2, gyro=1.0, accel0=2.0, accel1=3.0)
    payload = struct.pack("<B2h3f", 7, 1, 2, 1.0, 2.0, 3.0)
    assert cobs_decode(s.as_cobs()) == payload


@pytest.mark.skipif(not native_available(), reason="needs native lib")
def test_serial_pty_loopback():
    """uart.rs smoke test over a PTY: host sends Control, fake MCU replies
    with an 18-byte framed State (uart.rs:13-31)."""
    from mpc_rs_jax.io.serial import PtyPair, SerialPort

    pair = PtyPair()
    try:
        with SerialPort(pair.slave_path, 115200, timeout_ms=200) as port:
            port.write_packet(Control(u=1234))
            frame = pair.mcu_recv()
            c = Control.from_cobs(frame[-Control.buf_size():])
            assert c is not None and c.u == 1234

            st = State(x=0.5, dx=0.0, theta=0.1, dtheta=0.0)
            pair.mcu_send(st.as_cobs())
            got = port.read_packet(State)
            assert got is not None
            np.testing.assert_allclose(got.to_vector(), [0.5, 0.0, 0.1, 0.0], atol=1e-7)

            # resync: garbage before a valid frame must still parse (the
            # reference slices the last BUF_SIZE bytes — mppi4-commu.rs:109-117)
            pair.mcu_send(b"\x07\x12\x54" + st.as_cobs())
            got2 = port.read_packet(State)
            assert got2 is not None
            np.testing.assert_allclose(got2.to_vector(), [0.5, 0.0, 0.1, 0.0], atol=1e-7)

            # timeout path: nothing sent → None, no hang
            assert port.read_packet(State) is None
    finally:
        pair.close()


def test_sensor_and_sensor2_roundtrip():
    s = Sensor(encoder0=-123, encoder1=456, gyro=7.5)
    s2 = Sensor.from_cobs(s.as_cobs())
    np.testing.assert_allclose(s2.to_vector(), [-123.0, 456.0, 7.5])
    t = Sensor2(encoder0=1, encoder1=-2, gyro=0.5, accel0=-0.25, accel1=1.75)
    t2 = Sensor2.from_cobs(t.as_cobs())
    np.testing.assert_allclose(t2.to_vector(), [1.0, -2.0, 0.5, -0.25, 1.75])


def test_from_cobs_rejects_wrong_size():
    frame = Control(u=5).as_cobs()
    assert State.from_cobs(frame) is None  # 2-byte payload can't be a State
