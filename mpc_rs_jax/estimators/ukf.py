"""Unscented Kalman filter — dimension-generic, batchable, f32-safe.

Replaces the reference's two hard-coded copies (src/ukf.rs: N=4/O=3,
src/ukf2.rs: N=6/O=5 — byte-identical algorithms) with one implementation
parameterized by the state/obs dimensions, plus:

- ``set_q`` AND ``set_r`` (plain functional field replacement) — fixing the
  reference's missing ``ukf2::set_r`` that breaks two examples
  (SURVEY §2 C4; examples/mppi4-ukf-commu.rs:280).
- sigma-point square root via ``eigh`` of the symmetrized C·P — the
  symmetric-PSD equivalent of the reference's SVD choice
  (src/ukf.rs:120-132: L = U·√Σ; for symmetric PSD, U√Σ matches V√λ up to
  column order/sign, and ±L columns make both irrelevant), with negative
  eigenvalues clamped to 0 so near-PSD covariances degrade gracefully
  instead of panicking (``.expect("Cholesky fail")``).
- Kalman gain via ``solve`` (no explicit inverse; reference panics on
  singular Pz, src/ukf.rs:69).
- Merwe weights α=1e-3, β=2, κ=3−n (src/ukf.rs:23-28).

Batch thousands of independent filters with ``jax.vmap`` over ``UkfState``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

# A default-precision f32 dot may run in TF32 on the GPU (about three
# decimal digits); covariance algebra cannot survive that. All contractions
# here pin full-f32 accumulation.
_HI = jax.lax.Precision.HIGHEST


class UkfParams(NamedTuple):
    wm: jax.Array  # (M,) mean weights
    wc: jax.Array  # (M,) covariance weights
    c: float  # C = α²(n+κ) — sigma scaling (src/ukf.rs:27)
    n: int
    n_obs: int
    # 'eigh': graceful on near-PSD P (mirrors the reference's SVD choice) —
    # default, best on CPU/f64. 'jacobi': same eigen-direction sigma
    # placement via the unrolled batched Jacobi (smallalg) — elementwise
    # math for vmapped fleets. 'cholesky': jittered Cholesky — fastest, but
    # the UT is not sqrt-invariant through nonlinear fx and Cholesky
    # directions can cost estimation quality on anisotropic covariances.
    sqrt_method: str = "eigh"


class UkfState(NamedTuple):
    x: jax.Array  # (n,) mean
    p: jax.Array  # (n, n) covariance
    q: jax.Array  # (n, n) process noise  (set_q: state._replace(q=...))
    r: jax.Array  # (o, o) measurement noise (set_r: state._replace(r=...))
    sigma_f: jax.Array  # (2n+1, n) propagated sigma points from last predict


def merwe_weights(n: int, alpha: float = 1e-3, beta: float = 2.0, kappa: float | None = None, dtype=jnp.float32):
    """Merwe scaled weights — src/ukf.rs:112-118.

    f32 guidance: the default α=1e-3 (the reference's constant) makes the
    non-center weights 1/(2α²(n+κ)) ≈ 1.7e5, which amplifies the ulp
    rounding of every propagated sigma point into the transformed mean —
    fine in f64, but in f32 it injects O(1e5·ulp(|fx|)) ≈ 1e-2 noise per
    transform (tests/test_ukf.py::test_f32_predict_alpha_conditioning;
    DESIGN §18). For f32 filters prefer α=1: Julier-spread sigma points with
    the Merwe β=2 covariance correction (the UT stays 2nd-order exact for
    any α) — the fleet tiers default to it (apps/fleet.py fleet_alpha)."""
    if kappa is None:
        kappa = 3.0 - n
    c = alpha * alpha * (n + kappa)
    lam = c - n
    m = 2 * n + 1
    wm = jnp.full((m,), 1.0 / (2.0 * c), dtype=dtype)
    wc = jnp.full((m,), 1.0 / (2.0 * c), dtype=dtype)
    wm = wm.at[0].set(lam / c)
    wc = wc.at[0].set(lam / c + 1.0 - alpha * alpha + beta)
    return wm, wc, c


def ukf_init(
    x0, p0, q, r, *, alpha: float = 1e-3, beta: float = 2.0, kappa: float | None = None,
    sqrt_method: str = "eigh",
):
    """Create (UkfParams, UkfState). sigma_f starts NaN as in src/ukf.rs:32."""
    x0 = jnp.asarray(x0)
    n = x0.shape[-1]
    r = jnp.asarray(r)
    o = r.shape[-1]
    wm, wc, c = merwe_weights(n, alpha, beta, kappa, dtype=x0.dtype)
    sigma_f = jnp.full((2 * n + 1, n), jnp.nan, dtype=x0.dtype)
    return (
        UkfParams(wm=wm, wc=wc, c=c, n=n, n_obs=o, sqrt_method=sqrt_method),
        UkfState(x=x0, p=jnp.asarray(p0), q=jnp.asarray(q), r=r, sigma_f=sigma_f),
    )


def sigma_points(params: UkfParams, x: jax.Array, p: jax.Array) -> jax.Array:
    """(2n+1, n) sigma set {x, x±Lᵢ} with L = sqrt(C·P) — src/ukf.rs:120-132.

    'eigh': L = V√λ (clamped), symmetric-PSD equivalent of the reference's
    SVD. 'cholesky': L = chol(C·P + jitter·I)ᵀ rows; jitter is relative to
    the mean diagonal so near-PSD covariances stay factorizable."""
    s = params.c * p
    s = (s + jnp.swapaxes(s, -1, -2)) / 2.0
    n = s.shape[-1]
    if params.sqrt_method == "cholesky":
        from mpc_rs_jax.estimators.smallalg import chol_unrolled

        jitter = 1e-6 * (jnp.trace(s, axis1=-2, axis2=-1) / n + 1e-30)
        l = chol_unrolled(s + jitter[..., None, None] * jnp.eye(n, dtype=s.dtype))
        deltas = jnp.swapaxes(l, -1, -2)  # row i = column i of chol factor
        deltas = jnp.where(jnp.isfinite(deltas), deltas, 0.0)
    elif params.sqrt_method == "jacobi":
        # Eigen-direction sigma placement via the unrolled batched Jacobi
        # (smallalg) — pure elementwise math that fuses into a vmapped
        # tick. Validated
        # equivalent to exact 'eigh': moment-contract + linear-filter
        # equality tests (tests/test_ukf.py) and tip-for-tip identical
        # flagship-fleet survival across 4 seeds at B=1024 (DESIGN.md §5).
        from mpc_rs_jax.estimators.smallalg import eigh_jacobi_unrolled

        w, v = eigh_jacobi_unrolled(s)
        l = v * jnp.sqrt(jnp.maximum(w, 0.0))[..., None, :]
        deltas = jnp.swapaxes(l, -1, -2)
    else:
        w, v = jnp.linalg.eigh(s)
        l = v * jnp.sqrt(jnp.maximum(w, 0.0))[..., None, :]  # columns Lᵢ = vᵢ√λᵢ
        deltas = jnp.swapaxes(l, -1, -2)  # (n, n): row i = Lᵢ
    return jnp.concatenate(
        [x[..., None, :], x[..., None, :] + deltas, x[..., None, :] - deltas], axis=-2
    )


def unscented_transform(wm, wc, sigmas, cov):
    """(mean, P) of a sigma set (M, S) + additive cov — src/ukf.rs:96-110.

    The mean uses a cancellation-free form exploiting the symmetric Merwe
    structure: with α=1e-3 the center weight is O(∓1e6) (wm[0] ≈ −2e6 for
    n=6), so the textbook Σ wm·σ catastrophically cancels in f32 (the
    reference is f64-only and never hits this — SURVEY §7 hard part (b)).
    Because wm[0] + 2n·wm[1] = 1 exactly, mean = σ₀ + wm[1]·Σᵢ dᵢ with
    dᵢ = σᵢ − σ₀; summing the ± pairs first cancels the O(L) parts before
    the 1/(2C) ≈ 1e5 weight ever multiplies them. Requires the standard
    (2n+1)-point set with equal non-center weights (merwe_weights)."""
    m = sigmas.shape[-2]
    n = (m - 1) // 2
    s0 = sigmas[..., 0, :]
    d = sigmas - s0[..., None, :]
    pair = d[..., 1 : n + 1, :] + d[..., n + 1 :, :]
    mean = s0 + wm[..., 1, None] * jnp.sum(pair, axis=-2)
    y = sigmas - mean[..., None, :]
    p = jnp.einsum("...m,...ms,...mt->...st", wc, y, y, precision=_HI) + cov
    return mean, p


def ukf_predict(params: UkfParams, state: UkfState, u, fx: Callable) -> UkfState:
    """Time update — src/ukf.rs:44-52.

    ``fx(x, u) -> x`` vector form on (..., n); broadcasting over the sigma
    axis (our models broadcast; wrap with vmap otherwise)."""
    sig = sigma_points(params, state.x, state.p)
    sigma_f = fx(sig, u)
    x, p = unscented_transform(params.wm, params.wc, sigma_f, state.q)
    return state._replace(x=x, p=p, sigma_f=sigma_f)


def ukf_update(params: UkfParams, state: UkfState, z, hx: Callable) -> UkfState:
    """Measurement update — src/ukf.rs:54-74.

    Gain by linear solve of Pz Kᵀ = Pxzᵀ; covariance symmetrized (:72-73)."""
    sigmas_h = hx(state.sigma_f)
    zp, pz = unscented_transform(params.wm, params.wc, sigmas_h, state.r)
    yf = state.sigma_f - state.x[..., None, :]
    yh = sigmas_h - zp[..., None, :]
    pxz = jnp.einsum("...m,...ms,...mt->...st", params.wc, yf, yh, precision=_HI)
    if params.sqrt_method == "cholesky":
        # Pz is SPD: unrolled Cholesky solve fuses into the batched tick.
        # NOT used for 'jacobi': on ill-conditioned Pz (rpm var ~4e4 vs
        # accel var ~2.5e-3, cond ~1e7) the f32 unrolled solve loses the
        # gain's small-channel digits (flagship survival 0.23 vs 1.00);
        # jnp.linalg.solve's pivoted LU keeps them
        from mpc_rs_jax.estimators.smallalg import spd_solve_unrolled

        k = spd_solve_unrolled(pz, jnp.swapaxes(pxz, -1, -2))
    else:
        k = jnp.linalg.solve(jnp.swapaxes(pz, -1, -2), jnp.swapaxes(pxz, -1, -2))
    k = jnp.swapaxes(k, -1, -2)  # K = Pxz Pz⁻¹
    x = state.x + jnp.einsum("...st,...t->...s", k, z - zp, precision=_HI)
    p = state.p - jnp.einsum("...su,...uv,...tv->...st", k, pz, k, precision=_HI)
    p = (p + jnp.swapaxes(p, -1, -2)) / 2.0
    return state._replace(x=x, p=p)


def ukf_step(params, state, u, z, fx, hx):
    """predict + update in one jit-friendly call."""
    return ukf_update(params, ukf_predict(params, state, u, fx), z, hx)


def ukf_guard(state: UkfState, p_reset) -> UkfState:
    """Failure recovery: re-arm a filter whose state went non-finite.

    The reference panics on numeric failure (src/ukf.rs:69
    ``.expect("Inverse fail")``); long-running batched fleets instead degrade
    gracefully (SURVEY §5): non-finite mean entries are zeroed and the
    covariance is reset to ``p_reset``, so the filter re-converges from its
    own measurements instead of propagating NaN forever. Batched: the reset
    applies per instance."""
    p_reset = jnp.asarray(p_reset, dtype=state.p.dtype)
    bad = ~(
        jnp.all(jnp.isfinite(state.x), axis=-1)
        & jnp.all(jnp.isfinite(state.p), axis=(-2, -1))
    )
    x = jnp.where(jnp.isfinite(state.x), state.x, 0.0)
    p = jnp.where(bad[..., None, None], p_reset, state.p)
    return state._replace(x=x, p=p)
