"""Polynomial f32 sin/cos for the rollout dynamics (behind a flag).

The fused MPPI kernel spends much of each rollout step in the dynamics'
sin/cos. Inside a Triton kernel ``jnp.sin``/``jnp.cos`` become libdevice's
accurate routines; these mul/add-only replacements made the kernel 8% (K=819,200)
to 15% (K=10,240) faster on an H100 (PERF.md):

- ``fsin``/``fcos``/``fsincos``: round-to-nearest range reduction to
  [−π, π], a quadrant fold to [−π/2, π/2], then a degree-9 Taylor
  polynomial. Max abs error ≈ 3e-6; finite for any finite input.

Exact-parity tests keep the flag off; tolerance tests (tests/test_fastmath)
pin the error bounds, far below MPPI's sampling noise floor.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

_TWO_PI = 2.0 * math.pi
_INV_TWO_PI = np.float32(1.0 / _TWO_PI)
_PI = np.float32(math.pi)
_HALF_PI = np.float32(math.pi / 2.0)
# sin Taylor deg-9 on the folded range [−π/2, π/2] (max err ~2.7e-6)
_S3 = np.float32(-1.0 / 6.0)
_S5 = np.float32(1.0 / 120.0)
_S7 = np.float32(-1.0 / 5040.0)
_S9 = np.float32(1.0 / 362880.0)


def _reduce_pi(x):
    """x − 2π·round(x/2π) ∈ [−π, π] (floor(·+½): Triton has no round)."""
    k = jnp.floor(x * _INV_TWO_PI + 0.5)
    # two-step multiply keeps f32 cancellation error small for |x| ≲ 1e4
    hi = np.float32(6.28125)  # 2π split: hi + lo
    lo = np.float32(_TWO_PI - 6.28125)
    r = (x - k * hi) - k * lo
    # huge |x| defeats f32 reduction; clamp keeps the poly finite (values
    # are meaningless there, exactly like the rollout they came from)
    return jnp.clip(r, -_PI, _PI)


def _sin_folded(r):
    """sin on r ∈ [−π, π] via quadrant fold: sin(r) = sin(±π − r) outside
    ±π/2, which lands the polynomial argument in [−π/2, π/2]."""
    r = jnp.where(r > _HALF_PI, _PI - r, jnp.where(r < -_HALF_PI, -_PI - r, r))
    r2 = r * r
    return r + r * r2 * (_S3 + r2 * (_S5 + r2 * (_S7 + r2 * _S9)))


def fsin(x):
    return _sin_folded(_reduce_pi(x))


def fcos(x):
    # cos x = sin(x + π/2), reduced in its own pass
    return _sin_folded(_reduce_pi(x + _HALF_PI))


def fsincos(x):
    """(sin x, cos x)."""
    return fsin(x), fcos(x)
