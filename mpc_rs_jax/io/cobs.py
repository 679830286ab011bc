"""COBS framing codec — C++ native implementation with a Python fallback.

Parity with the reference's ``cobs_rs`` usage (src/packet.rs:43-61):
``cobs_encode(payload)`` = ``stuff(buf, 0)`` → len(payload)+2 bytes for
payloads ≤ 253 (one overhead byte + trailing 0x00 delimiter);
``cobs_decode(frame)`` = ``unstuff(buf, 0)``.

The native library (native/mpcio.cpp) is auto-built with g++ on first use;
the pure-Python path is bit-identical (cross-checked in tests/test_io.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libmpcio.so")

_lib = None


def _load_native():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "libmpcio.so"], check=True,
                           capture_output=True)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    lib.mpcio_cobs_stuff.restype = ctypes.c_int
    lib.mpcio_cobs_stuff.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.mpcio_cobs_unstuff.restype = ctypes.c_int
    lib.mpcio_cobs_unstuff.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.mpcio_serial_open.restype = ctypes.c_int
    lib.mpcio_serial_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.mpcio_serial_read_until_zero.restype = ctypes.c_int
    lib.mpcio_serial_read_until_zero.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
    lib.mpcio_serial_write.restype = ctypes.c_int
    lib.mpcio_serial_write.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.mpcio_serial_close.argtypes = [ctypes.c_int]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_native() is not None


def _py_cobs_encode(data: bytes) -> bytes:
    out = bytearray()
    code_idx = 0
    out.append(0)  # placeholder for first code byte
    code = 1
    for b in data:
        if b == 0:
            out[code_idx] = code
            code_idx = len(out)
            out.append(0)
            code = 1
        else:
            out.append(b)
            code += 1
            if code == 0xFF:
                out[code_idx] = code
                code_idx = len(out)
                out.append(0)
                code = 1
    out[code_idx] = code
    out.append(0x00)
    return bytes(out)


def _py_cobs_decode(frame: bytes) -> bytes:
    if frame and frame[-1] == 0:
        frame = frame[:-1]
    out = bytearray()
    i = 0
    n = len(frame)
    while i < n:
        code = frame[i]
        if code == 0:
            raise ValueError("unexpected 0x00 inside COBS frame")
        i += 1
        if i + code - 1 > n:
            raise ValueError("truncated COBS frame")
        out.extend(frame[i : i + code - 1])
        i += code - 1
        if code != 0xFF and i < n:
            out.append(0)
    return bytes(out)


def cobs_encode(data: bytes, use_native: bool | None = None) -> bytes:
    lib = _load_native() if use_native in (None, True) else None
    if lib is None:
        if use_native is True:
            raise RuntimeError("native mpcio library unavailable")
        return _py_cobs_encode(data)
    cap = len(data) + 2 + len(data) // 254 + 2
    buf = (ctypes.c_uint8 * cap)()
    n = lib.mpcio_cobs_stuff(data, len(data), buf, cap)
    if n < 0:
        raise ValueError("COBS encode failed")
    return bytes(buf[:n])


def cobs_decode(frame: bytes, use_native: bool | None = None) -> bytes:
    lib = _load_native() if use_native in (None, True) else None
    if lib is None:
        if use_native is True:
            raise RuntimeError("native mpcio library unavailable")
        return _py_cobs_decode(frame)
    cap = max(len(frame), 1)
    buf = (ctypes.c_uint8 * cap)()
    n = lib.mpcio_cobs_unstuff(frame, len(frame), buf, cap)
    if n < 0:
        raise ValueError("COBS decode failed")
    return bytes(buf[:n])
