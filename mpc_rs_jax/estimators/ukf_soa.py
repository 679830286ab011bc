"""Batch-minor ("structure-of-arrays") UKF for fleets.

The standard batched UKF (``estimators.ukf`` under ``jax.vmap``) carries
covariances as (B, n, n), so every op works on tiny 6×6 minor tiles. At
fleet batch sizes the UKF half of a scenario tick is dominated by exactly
such ops (the unrolled Jacobi rotations, the UT accumulations).

This module flips the layout: every matrix/vector ENTRY is a (B,) array
and B is the minor axis. All small-dimension structure (n ≤ 6 states,
m = 2n+1 sigma points, o ≤ 5 observations) is unrolled in Python into
pure elementwise (B,) math. Internally everything is nested lists of (B,) arrays;
the public API converts from/to the batch-leading (B, ...) arrays the
scenario carry uses (two cheap transposes per tick).

Algorithmic parity with ``estimators.ukf`` (same reference citations,
src/ukf.rs / src/ukf2.rs):
- Merwe weights, cancellation-free f32 UT mean (pair-summed deltas),
- eigen-direction sigma placement via unrolled cyclic Jacobi (the same
  rotation sequence as ``smallalg.eigh_jacobi_unrolled``),
- covariance symmetrization after the update,
- Kalman gain via an **equilibrated** unrolled Cholesky solve: Pz is
  diagonally scaled to unit diagonal before factorization. This is what
  makes an unrolled f32 solve safe where the raw one was not — the
  flagship's Pz mixes rpm variance ~4e4 with accel variance ~2.5e-3
  (cond ~1e7 from SCALE, not from correlation); after D⁻½ Pz D⁻½ the
  condition number collapses to the correlation structure's (~1), and
  the unrolled factorization keeps the small channels' digits
  (tests/test_ukf_soa.py pins the gain against a pivoted f64 solve).

fx/hx are COMPONENT form here: ``fx(xs: tuple[n of (B,)], u: (B,)) ->
tuple[n of (B,)]`` and ``hx(xs) -> tuple[o of (B,)]`` — elementwise over
the batch, so sin/cos in the observation model also run elementwise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax.numpy as jnp

from mpc_rs_jax.estimators.smallalg import jacobi_entries


class SoaUkfState(NamedTuple):
    x: tuple  # n of (B,)
    p: tuple  # n of n of (B,)
    sigma_f: tuple  # n of (m, B...) — COMPONENT-STACKED propagated sigma
    # points: one array per state component with the m points on the
    # leading axis. This shape exists so fx/hx are traced ONCE over all m
    # points: the per-point form unrolled 13 copies of the flagship
    # dynamics over column-sliced operands. Stacked (m, B) operands keep B
    # on the minor axis.


def from_batched(x, p, sigma_f):
    """(B, n), (B, n, n), (B, m, n) -> SoaUkfState."""
    n = x.shape[-1]
    return SoaUkfState(
        x=tuple(x[:, i] for i in range(n)),
        p=tuple(tuple(p[:, i, j] for j in range(n)) for i in range(n)),
        sigma_f=tuple(jnp.swapaxes(sigma_f[..., i], 0, 1) for i in range(n)),
    )


def to_batched(state: SoaUkfState):
    """SoaUkfState -> ((B, n), (B, n, n), (B, m, n))."""
    x = jnp.stack(state.x, axis=-1)
    p = jnp.stack([jnp.stack(row, axis=-1) for row in state.p], axis=-2)
    sf = jnp.swapaxes(jnp.stack(state.sigma_f, axis=-1), 0, 1)
    return x, p, sf


def _sigma_points_soa(c, x, p, n):
    """m=2n+1 sigma points {x, x±Lᵢ}, L rows = eigenvector·√λ (src/ukf.rs:120-132)."""
    s = [[0.5 * c * (p[i][j] + p[j][i]) for j in range(n)] for i in range(n)]
    w, v = jacobi_entries(s, n)
    sq = [jnp.sqrt(jnp.maximum(w[i], 0.0)) for i in range(n)]
    # delta[i][j] = v[j][i] * sqrt(w[i])  (row i of Lᵀ = i-th eigen direction)
    deltas = [[v[j][i] * sq[i] for j in range(n)] for i in range(n)]
    pts = [list(x)]
    for i in range(n):
        pts.append([x[j] + deltas[i][j] for j in range(n)])
    for i in range(n):
        pts.append([x[j] - deltas[i][j] for j in range(n)])
    return pts


def _ut_soa(wm1, wc1, sum_wc, fm, cov, n, dim):
    """Unscented transform (src/ukf.rs:96-110) with the cancellation-free
    f32 mean (pair-summed deltas; see estimators.ukf) AND the
    cancellation-free shifted covariance (below).

    ``fm``: COMPONENT-STACKED sigma values — list dim of (m, B...) arrays.
    ``cov``: additive (dim, dim) constants or (B,)-entry lists.
    Returns (mean: list dim, (d, e, sd) shift pieces, P: list dim×dim)."""
    s0 = [fm[j][0] for j in range(dim)]
    # per-component deltas (2n, B...) — B on the minor axis
    deltas = [fm[j][1:] - fm[j][:1] for j in range(dim)]
    mean = [
        s0[j] + wm1 * jnp.sum(deltas[j][:n] + deltas[j][n:], axis=0)
        for j in range(dim)
    ]
    # Shifted (cancellation-free) covariance: with d_k = σ_k − σ₀ and
    # e = mean − σ₀,  Σ wc (σ−mean)(σ−mean)ᵀ
    #   = Σ_{k≥1} wc1 d dᵀ − s_d eᵀ − e s_dᵀ + (Σwc)·e eᵀ     (d₀ = 0!)
    # The textbook form multiplies the center deviation by wc0 ≈ −1.3e6
    # (α=1e-3 Merwe); in f32 that one term cancels against the Σ of
    # moderate terms and costs ~1e-3 relative noise in P — measured as a
    # real flagship-fleet survival gap (0.989 vs 0.999; the AoS einsum
    # path survives because Precision.HIGHEST keeps full f32 products).
    # Here NO intermediate carries a 1e6-scale weight:
    # sum_wc = wc0 + 2n·wc1 = 2 + β − α² ≈ 4 (computed cancellation-free
    # by the caller as 1 + (wc0 − wm0)).
    # stacked forms keep the trace small (dim²·m scalar nodes made XLA's
    # CPU pipeline blow up on the 6-state/5-obs flagship: tick compile
    # >2 min; a handful of (dim, B) / (dim, dim, B) array ops compiles in
    # seconds — B stays minor).
    # The k-sum of outer products is an UNROLLED accumulation over the 2n
    # per-k (dim, dim, B) FMAs rather than one (2n, dim, dim, B) einsum:
    # the stacked form materializes a 14 MB intermediate at the flagship's
    # (12, 6, 6, 1024) through device memory. The accumulator form peaks
    # at one (dim, dim, B) live value and fuses into a single pass.
    dstack = jnp.stack(deltas, axis=1)  # (2n, dim, B...)
    estack = jnp.stack([mean[j] - s0[j] for j in range(dim)])  # (dim, B...)
    # unrolled axis-0 accumulation (fuses into the same single pass)
    sdstack = dstack[0]
    for k in range(1, 2 * n):
        sdstack = sdstack + dstack[k]
    sdstack = wc1 * sdstack  # (dim, B...)
    core = dstack[0][:, None] * dstack[0][None, :]
    for k in range(1, 2 * n):
        core = core + dstack[k][:, None] * dstack[k][None, :]
    core = wc1 * core  # (dim, dim, B...)
    pstack = (
        core - sdstack[:, None] * estack[None, :] - estack[:, None] * sdstack[None, :]
        + sum_wc * (estack[:, None] * estack[None, :])
    )
    pmat = [[pstack[a_, b_] + cov[a_][b_] for b_ in range(dim)] for a_ in range(dim)]
    return mean, (dstack, estack, sdstack), pmat


def _chol_solve_equilibrated(pz, rhs_rows, o):
    """Solve Pz·X = rhs (column-stack) via diagonal equilibration + unrolled
    Cholesky; entries are (B,) arrays.

    ``rhs_rows``: list of rhs columns, each a list o of (B,) entries.
    Returns solutions in the same structure. Equilibration: with
    D = diag(Pz)^½, solve (D⁻¹PzD⁻¹)(DX) = D⁻¹rhs — the scaled matrix has
    unit diagonal so the f32 factorization is scale-free."""
    eps = jnp.asarray(1e-30, pz[0][0].dtype)
    dinv = [1.0 / jnp.sqrt(jnp.maximum(pz[i][i], eps)) for i in range(o)]
    a = [[pz[i][j] * dinv[i] * dinv[j] for j in range(o)] for i in range(o)]
    # unrolled Cholesky a = L Lᵀ
    l = [[None] * o for _ in range(o)]
    for i in range(o):
        for j in range(i + 1):
            acc = a[i][j]
            for k in range(j):
                acc = acc - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = jnp.sqrt(jnp.maximum(acc, eps))
            else:
                l[i][j] = acc / l[j][j]
    def tri_solve(b):
        # forward L y = b, back Lᵀ z = y
        y = [None] * o
        for i in range(o):
            acc = b[i]
            for k in range(i):
                acc = acc - l[i][k] * y[k]
            y[i] = acc / l[i][i]
        zz = [None] * o
        for i in reversed(range(o)):
            acc = y[i]
            for k in range(i + 1, o):
                acc = acc - l[k][i] * zz[k]
            zz[i] = acc / l[i][i]
        return zz

    outs = []
    for rhs in rhs_rows:
        b = [rhs[i] * dinv[i] for i in range(o)]
        zz = tri_solve(b)
        # one step of iterative refinement on the equilibrated system:
        # f32 Cholesky alone leaves ~1e-6·cond(corr) relative error in the
        # gain, which the flagship's stability margin can feel (fleet
        # survival 0.989 vs 0.999); the residual re-solve recovers the
        # pivoted-LU-grade digits at ~2× the (tiny) solve cost.
        resid = [b[i] - sum(a[i][k] * zz[k] for k in range(o)) for i in range(o)]
        dz = tri_solve(resid)
        zz = [zz[i] + dz[i] for i in range(o)]
        outs.append([zz[i] * dinv[i] for i in range(o)])
    return outs


def soa_predict(params, state: SoaUkfState, u, fx: Callable, q) -> SoaUkfState:
    """Time update (src/ukf.rs:44-52). ``fx`` component form; ``q`` an
    (n, n) array-like of scalars (the fleets' additive process noise)."""
    n = params.n
    m = 2 * n + 1
    wm1, wc1 = params.wm[1], params.wc[1]
    sum_wc = 1.0 + (params.wc[0] - params.wm[0])  # = 2+β−α², cancellation-free
    pts = _sigma_points_soa(params.c, state.x, state.p, n)
    # stack the m sigma points per component and trace fx ONCE over all of
    # them — (m, B...) operands keep B on the minor axis and avoid m copies
    # of the dynamics in the graph (see SoaUkfState.sigma_f)
    xs_m = tuple(jnp.stack([pts[k][j] for k in range(m)]) for j in range(n))
    u_b = jnp.asarray(u)[None]
    fm = [jnp.broadcast_to(c_, xs_m[0].shape) for c_ in fx(xs_m, u_b)]
    qrows = [[q[i][j] for j in range(n)] for i in range(n)]
    mean, _, pmat = _ut_soa(wm1, wc1, sum_wc, fm, qrows, n, n)
    return SoaUkfState(x=tuple(mean), p=tuple(tuple(r) for r in pmat),
                       sigma_f=tuple(fm))


def soa_update(params, state: SoaUkfState, z, hx: Callable, r) -> SoaUkfState:
    """Measurement update (src/ukf.rs:54-74): UT of hx(sigma_f), cross-cov,
    equilibrated-Cholesky gain, symmetrized covariance. ``z``: list o of
    (B,); ``r``: (o, o) scalars."""
    n, o = params.n, params.n_obs
    wm1, wc1 = params.wm[1], params.wc[1]
    sum_wc = 1.0 + (params.wc[0] - params.wm[0])
    # hx traced ONCE over the component-stacked (m, B...) sigma points
    hm = [jnp.broadcast_to(c_, state.sigma_f[0].shape)
          for c_ in hx(tuple(state.sigma_f))]
    rrows = [[r[i][j] for j in range(o)] for i in range(o)]
    zp, (dh, eh, sdh), pz = _ut_soa(wm1, wc1, sum_wc, hm, rrows, n, o)
    # cross-covariance in the same shifted (wc0-free) form:
    # Pxz = Σ_{k≥1} wc1 df dhᵀ − sdf ehᵀ − ef sdhᵀ + (Σwc) ef ehᵀ
    s0f = [state.sigma_f[i][0] for i in range(n)]
    dfstack = jnp.stack(
        [state.sigma_f[i][1:] - state.sigma_f[i][:1] for i in range(n)],
        axis=1,
    )  # (2n, n, B)
    efstack = jnp.stack([state.x[i] - s0f[i] for i in range(n)])  # (n, B)
    sdfstack = dfstack[0]
    for k in range(1, 2 * n):
        sdfstack = sdfstack + dfstack[k]
    sdfstack = wc1 * sdfstack
    # unrolled k-accumulation (not a (2n, n, o, B) einsum) — see _ut_soa
    pxz_core = dfstack[0][:, None] * dh[0][None, :]
    for k in range(1, 2 * n):
        pxz_core = pxz_core + dfstack[k][:, None] * dh[k][None, :]
    pxz_core = wc1 * pxz_core  # (n, o, B)
    pxz_stack = (
        pxz_core - sdfstack[:, None] * eh[None, :] - efstack[:, None] * sdh[None, :]
        + sum_wc * (efstack[:, None] * eh[None, :])
    )
    pxz = [[pxz_stack[a_, b_] for b_ in range(o)] for a_ in range(n)]
    # K = Pxz Pz⁻¹: solve Pz Kᵀ = Pxzᵀ column by column (Pz symmetric)
    krows = _chol_solve_equilibrated(pz, [list(row) for row in pxz], o)
    innov = [z[j] - zp[j] for j in range(o)]
    x = [state.x[i] + sum(krows[i][j] * innov[j] for j in range(o)) for i in range(n)]
    # P -= K Pz Kᵀ, then symmetrize
    kpz = [[sum(krows[i][k] * pz[k][j] for k in range(o)) for j in range(o)]
           for i in range(n)]
    pnew = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i, n):
            dec = sum(kpz[i][k] * krows[j][k] for k in range(o))
            val = 0.5 * (state.p[i][j] + state.p[j][i]) - dec
            pnew[i][j] = val
            pnew[j][i] = val
    return SoaUkfState(x=tuple(x), p=tuple(tuple(r_) for r_ in pnew),
                       sigma_f=state.sigma_f)


def soa_guard(state: SoaUkfState, p_reset) -> SoaUkfState:
    """Per-instance NaN recovery (mirrors estimators.ukf.ukf_guard). The
    isfinite sweep runs on ONE (n+n², B...) stack instead of n+n²
    column-sliced ops."""
    n = len(state.x)
    allv = jnp.stack(
        list(state.x) + [state.p[i][j] for i in range(n) for j in range(n)]
    )
    bad = ~jnp.all(jnp.isfinite(allv), axis=0)
    x = tuple(jnp.where(jnp.isfinite(xi), xi, 0.0) for xi in state.x)
    p = tuple(
        tuple(jnp.where(bad, jnp.asarray(p_reset[i][j], state.p[i][j].dtype), state.p[i][j])
              for j in range(n))
        for i in range(n)
    )
    return SoaUkfState(x=x, p=p, sigma_f=state.sigma_f)
