"""Observation-model (hx) zoo — sensor maps from the reference examples.

Vector-form signatures ``hx(x) -> z`` with x of shape (..., n_state) and z
of shape (..., n_obs); broadcasting over leading axes makes them directly
usable on (M, n) sigma-point stacks.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from mpc_rs_jax.models.params import CartPoleParams

_RAD2DEG = 180.0 / math.pi


def make_hx_rpm_gyro4(p: CartPoleParams):
    """4-state → [rpm, rpm, deg/s] — examples/ukf-pen2.rs:47-53,
    mppi4-non-liner-s.rs:242-248.

    Wheel odometry 60/(2π R_W)·dx on both encoders, gyro θ̇ in deg/s."""
    k = 60.0 / (2.0 * math.pi * p.r_w)

    def hx(x):
        rpm = k * x[..., 1]
        return jnp.stack(
            jnp.broadcast_arrays(rpm, rpm, x[..., 3] * _RAD2DEG), axis=-1
        )

    return hx


def make_hx_vel2():
    """4-state → [dx, dtheta] — examples/ukf-pen.rs:86-91, mpc-ukf-x.rs:108-113."""

    def hx(x):
        return jnp.stack(jnp.broadcast_arrays(x[..., 1], x[..., 3]), axis=-1)

    return hx


def make_hx_imu6(p: CartPoleParams, gear: float = 36.0):
    """6-state → [rpm, −rpm, deg/s, az/G, ax/G] — mppi4-non-liner-ukf.rs:169-179,
    mpc-ukf-s.rs:193-203, mppi4-ukf-commu.rs:186-196.

    State [x, dx, ddx, theta, dtheta, ddtheta]; encoders geared (×36, one
    negated); IMU accelerations include gravity/centripetal/tangential terms:
    ax = G sinθ + ẍ cosθ + L θ̈ ;  az = G cosθ − ẍ sinθ + L θ̇².
    """
    k = gear * 60.0 / (2.0 * math.pi * p.r_w)

    def hx(x):
        dx, ddx = x[..., 1], x[..., 2]
        th, dth, ddth = x[..., 3], x[..., 4], x[..., 5]
        ax = p.g * jnp.sin(th) + ddx * jnp.cos(th) + p.l * ddth
        az = p.g * jnp.cos(th) - ddx * jnp.sin(th) + p.l * dth * dth
        return jnp.stack(
            jnp.broadcast_arrays(k * dx, -k * dx, dth * _RAD2DEG, az / p.g, ax / p.g),
            axis=-1,
        )

    return hx


def make_hx_force6(p: CartPoleParams):
    """6-state → force-based IMU variant — examples/ukf-pen3.rs:53-63.

    v = M2 G cosθ + M2 ẍ sinθ − M2 L θ̇² ; h = −M2 G sinθ + M2 ẍ cosθ + M2 L θ̈;
    encoders ungeared, both positive."""
    k = 60.0 / (2.0 * math.pi * p.r_w)

    def hx(x):
        dx, ddx = x[..., 1], x[..., 2]
        th, dth, ddth = x[..., 3], x[..., 4], x[..., 5]
        v = p.m2 * p.g * jnp.cos(th) + p.m2 * ddx * jnp.sin(th) - p.m2 * p.l * dth * dth
        h = -p.m2 * p.g * jnp.sin(th) + p.m2 * ddx * jnp.cos(th) + p.m2 * p.l * ddth
        return jnp.stack(
            jnp.broadcast_arrays(k * dx, k * dx, dth * _RAD2DEG, v / p.g, h / p.g),
            axis=-1,
        )

    return hx


def make_masked_hx(hx, enable_mask):
    """Zero disabled observation channels — mppi4-ukf-commu.rs:282-292.

    ``enable_mask``: (n_obs,) array of {0,1}; channels with 0 are zeroed in
    the predicted observation (paired with R-inflation, see
    models.noise.gen_r_mask)."""

    def masked(x):
        return hx(x) * enable_mask

    return masked


def make_gaussian_sensor(hx, stddevs):
    """Simulated sensor = hx(x) + diag(stddevs)·N(0,1) — e.g.
    mppi4-non-liner-ukf.rs:181-191. Explicit-key JAX PRNG replaces the
    reference's thread_rng (more reproducible by design)."""
    import jax

    sig = jnp.asarray(stddevs)

    def sensor(key, x):
        noise = sig * jax.random.normal(key, x.shape[:-1] + sig.shape, dtype=sig.dtype)
        return hx(x) + noise

    return sensor
