"""MPPI (Model Predictive Path Integral) controller — the plain JAX core.

Re-design of the reference's rayon-parallel sampler (src/mppi.rs:1-93) as a
pure function: ``vmap`` over K rollouts, ``lax.scan`` over the N-step
horizon, explicit threefry keys instead of per-thread
``Xoshiro256Plus::from_entropy`` (src/mppi.rs:39-45) — which makes sampling
reproducible, unlike the reference.

Math (src/mppi.rs:33-92):
  v_k   = clamp(u_n + eps_k),  eps_k ~ N(0, σ²)               (:38-45)
  c_k   = Σ_t cost(x_{t+1}),   x_{t+1} = dynamics(x_t, v_t)   (:48-58)
  s_k   = −c_k − Σ_i u_i σ⁻² v_{k,i}                          (:60-62)
  m     = max over finite s_k                                  (:65-69)
  w_k   = exp((s_k − m)/λ)                                     (:71-74)
  u'    = Σ_k w_k v_k / Σ_k w_k                                (:80-84)
with the error paths surfaced as status flags (no exceptions under jit):
  NO_FINITE ("Cannot calculate max", :69), SUM_ZERO (:76-78),
  INVALID_U (NaN/Inf u'[0], :86-89). On failure the returned sequence is
  zeros — the fallback every reference caller applies
  (examples/mppi4-non-liner-s.rs:132-136, mppi4-ukf-commu.rs:76-81).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class MppiStatus(enum.IntEnum):
    OK = 0
    NO_FINITE = 1  # "Cannot calculate max" — src/mppi.rs:69
    SUM_ZERO = 2  # "sum is zero"          — src/mppi.rs:77
    INVALID_U = 3  # "u is invalid"         — src/mppi.rs:88


@dataclasses.dataclass(frozen=True)
class MppiConfig:
    n_horizon: int  # N — prediction horizon steps
    n_rollouts: int  # K — sampled control sequences
    lambda_: float  # softmax temperature λ
    std_dev: float  # sampling σ (also the control-term weight σ⁻²)
    limit: tuple[float, float]  # box constraint on controls
    # Optional override of the control-term coefficient (default σ⁻²).
    # The reference has two inconsistent weightings: the library divides the
    # control term by λ (src/mppi.rs:60-74) while the inline mppi2 example
    # does not (examples/mppi2.rs:59-70: exp(−c/λ − Σ u/R·v)). Setting
    # control_inv = λ/R reproduces mppi2's weighting through this solver.
    control_inv: float | None = None


class MppiResult(NamedTuple):
    u_n: jax.Array  # (N,) new nominal control sequence (zeros on failure)
    status: jax.Array  # int32 MppiStatus
    # diagnostics
    min_cost: jax.Array  # best (max) score seen, for logging
    ess: jax.Array  # effective sample size of the softmax weights


def rollout_scores(dynamics, cost, x, v, u_n, std_dev, control_inv=None, unroll=False):
    """Scores s_k for sampled sequences v (K, N) from state x (component tuple).

    dynamics/cost are component-wise (see models.dynamics); the scan carries
    the per-rollout state components, shape (K,) each. ``unroll=True``
    unrolls the N steps (one XLA fusion chain instead of a loop).
    """
    k = v.shape[0]
    xs = tuple(jnp.broadcast_to(c, (k,)) for c in jnp.broadcast_arrays(*x))

    def body(carry, v_t):
        c_acc, xs = carry
        xs = dynamics(*xs, v_t)
        c_acc = c_acc + cost(*xs)
        return (c_acc, xs), None

    c0 = jnp.zeros((k,), dtype=v.dtype)
    (c_k, _), _ = jax.lax.scan(body, (c0, xs), v.T, unroll=unroll)
    inv = std_dev ** -2.0 if control_inv is None else control_inv
    control_term = jnp.sum(u_n * inv * v, axis=-1)  # src/mppi.rs:60-61
    return -c_k - control_term


def mppi_solve(
    cfg: MppiConfig,
    dynamics: Callable,
    cost: Callable,
    key: jax.Array,
    x,
    u_n: jax.Array,
    noise: jax.Array | None = None,
    unroll: bool = False,
) -> MppiResult:
    """One MPPI solve — the functional analogue of ``Mppi::compute``.

    ``x`` is a tuple of state components (scalars or arrays); ``u_n`` is the
    warm-started nominal sequence (N,). jit-able; all shapes static.

    ``noise``: optional externally supplied (K, N) perturbations ε (already
    scaled — σ is NOT applied again). Used for matched-noise cross-
    validation against the independent native oracle (native/oracle.cpp),
    where both implementations must see bit-identical samples.

    ``unroll``: unroll the horizon scan (see ``rollout_scores``).
    """
    n, k = cfg.n_horizon, cfg.n_rollouts
    dtype = u_n.dtype
    if noise is None:
        eps = cfg.std_dev * jax.random.normal(key, (k, n), dtype=dtype)
    else:
        eps = jnp.asarray(noise, dtype)
        if eps.shape != (k, n):
            raise ValueError(
                f"noise must have shape (n_rollouts, n_horizon) = ({k}, {n}), "
                f"got {eps.shape}; it must also already be scaled by std_dev"
            )
    v = jnp.clip(u_n + eps, cfg.limit[0], cfg.limit[1])  # src/mppi.rs:39-45

    s_k = rollout_scores(dynamics, cost, x, v, u_n, cfg.std_dev, cfg.control_inv, unroll)

    finite = jnp.isfinite(s_k)
    any_finite = jnp.any(finite)
    neg_inf = jnp.asarray(-jnp.inf, dtype)
    m = jnp.max(jnp.where(finite, s_k, neg_inf))  # src/mppi.rs:65-69
    w = jnp.exp((s_k - m) / cfg.lambda_)  # src/mppi.rs:71-74
    # non-finite scores contribute exp(-inf)=0 exactly as the reference's
    # filtered max + exp of -inf/λ does for -inf; guard NaN explicitly.
    w = jnp.where(finite, w, 0.0)
    w_sum = jnp.sum(w)
    sum_zero = w_sum == 0.0

    safe_sum = jnp.where(sum_zero, 1.0, w_sum)
    u_new = (w / safe_sum) @ v  # src/mppi.rs:80-84

    invalid = jnp.isnan(u_new[0]) | jnp.isinf(u_new[0])  # src/mppi.rs:86-89
    status = jnp.where(
        ~any_finite,
        jnp.int32(MppiStatus.NO_FINITE),
        jnp.where(
            sum_zero,
            jnp.int32(MppiStatus.SUM_ZERO),
            jnp.where(invalid, jnp.int32(MppiStatus.INVALID_U), jnp.int32(MppiStatus.OK)),
        ),
    )
    ok = status == jnp.int32(MppiStatus.OK)
    u_out = jnp.where(ok, u_new, jnp.zeros_like(u_new))
    ess = (w_sum * w_sum) / jnp.maximum(jnp.sum(w * w), jnp.asarray(1e-30, dtype))
    return MppiResult(u_n=u_out, status=status, min_cost=-m, ess=ess)


NEG_BIG = -3.4e38  # finite stand-in for −∞ in partial maxima


class MppiPartials(NamedTuple):
    """Softmax partials of a set of rollouts, merged by log-sum-exp across
    kernel blocks and devices (ops/mppi_pallas.py, parallel/)."""

    m: jax.Array  # max finite score (NEG_BIG if none)
    s: jax.Array  # Σ exp((score − m)/λ)
    uw: jax.Array  # (..., N) Σ exp((score − m)/λ) · v


def finalize_partials(cfg: MppiConfig, parts: MppiPartials, u_n: jax.Array):
    """(u_n', status) from merged partials — the status and zero-fallback
    rules of ``mppi_solve``."""
    no_finite = parts.m <= -3.3e38
    sum_zero = parts.s == 0.0
    u_new = (parts.uw / jnp.where(sum_zero, 1.0, parts.s)).astype(u_n.dtype)
    invalid = jnp.isnan(u_new[0]) | jnp.isinf(u_new[0])
    status = jnp.where(
        no_finite,
        jnp.int32(MppiStatus.NO_FINITE),
        jnp.where(
            sum_zero,
            jnp.int32(MppiStatus.SUM_ZERO),
            jnp.where(invalid, jnp.int32(MppiStatus.INVALID_U), jnp.int32(MppiStatus.OK)),
        ),
    )
    ok = status == jnp.int32(MppiStatus.OK)
    return jnp.where(ok, u_new, jnp.zeros_like(u_new)), status


def make_mppi_step(cfg: MppiConfig, dynamics, cost, jit: bool = True):
    """Convenience: returns jitted ``step(key, x, u_n) -> MppiResult``."""
    f = lambda key, x, u_n: mppi_solve(cfg, dynamics, cost, key, x, u_n)
    return jax.jit(f) if jit else f
