"""Unrolled small-matrix linear algebra for batched estimators.

``jnp.linalg.cholesky``/``solve`` lower to generic (loop-heavy) batched
routines. State dims here are 2..6, so the factorizations unroll
completely into a few dozen *elementwise* ops over the batch — work that
XLA fuses with the rest of the filter.

All functions broadcast over arbitrary leading batch dims.
"""

from __future__ import annotations

import jax.numpy as jnp


def chol_unrolled(s, eps_rel: float = 1e-12):
    """Lower-triangular L with L Lᵀ = s for SPD s (..., n, n), unrolled.

    Near-PSD semantics: a pivot that is ≤ eps_rel·mean-diag zeroes its
    whole column (that direction carries no uncertainty) instead of
    producing a ~1/√eps explosion or NaNs — mirrors the graceful
    eigenvalue clamping of the eigh path."""
    n = s.shape[-1]
    floor = eps_rel * (jnp.trace(s, axis1=-2, axis2=-1) / n + 1e-30)
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            acc = s[..., i, j]
            for k in range(j):
                acc = acc - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = jnp.sqrt(jnp.maximum(acc, 0.0))
            else:
                piv = l[j][j]
                good = piv * piv > floor
                l[i][j] = jnp.where(good, acc / jnp.where(good, piv, 1.0), 0.0)
    zero = jnp.zeros_like(s[..., 0, 0])
    rows = [
        jnp.stack([l[i][j] if j <= i else zero for j in range(n)], axis=-1)
        for i in range(n)
    ]
    return jnp.stack(rows, axis=-2)


def chol_solve_unrolled(l, b, eps: float = 1e-25):
    """Solve (L Lᵀ) x = b with lower-tri L (..., n, n), b (..., n, m).

    Zeroed pivot columns (see chol_unrolled) yield zero solution components
    rather than infinities."""
    n = l.shape[-1]

    def safe_div(num, piv):
        good = piv * piv > eps
        return jnp.where(good, num / jnp.where(good, piv, 1.0), 0.0)

    # forward: L y = b
    y = [None] * n
    for i in range(n):
        acc = b[..., i, :]
        for k in range(i):
            acc = acc - l[..., i, k, None] * y[k]
        y[i] = safe_div(acc, l[..., i, i, None])
    # backward: Lᵀ x = y
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - l[..., k, i, None] * x[k]
        x[i] = safe_div(acc, l[..., i, i, None])
    return jnp.stack(x, axis=-2)


def spd_solve_unrolled(a, b, jitter_rel: float = 0.0):
    """x with a x = b for SPD a (..., n, n), b (..., n, m), fully unrolled."""
    if jitter_rel:
        n = a.shape[-1]
        tr = jnp.trace(a, axis1=-2, axis2=-1) / n
        a = a + (jitter_rel * tr)[..., None, None] * jnp.eye(n, dtype=a.dtype)
    return chol_solve_unrolled(chol_unrolled(a), b)


def _jacobi_stacked_leading(a, v, n, sweeps: int = 4):
    """Cyclic Jacobi on a symmetric matrix stored with the (n, n) pair as
    the LEADING axes (arbitrary trailing batch dims — for the SoA fleet
    layout the batch is minor, so every op is lane-dense).

    Rows/columns are replaced by rebuilding with ``jnp.stack`` — NOT by
    arithmetic masking (the masked whole-matrix update form miscompiled
    under ``jit(vmap(...))`` on CPU XLA: two near-degenerate eigenvalues
    collapsed toward their mean, recon error ~5e-2 while unjitted paths
    were exact — tests/test_ukf.py::test_jacobi_jit_vmap_reconstructs),
    and NOT entry-by-entry scalar lists (thousands of scalar nodes made
    the XLA CPU pipeline take minutes to compile a fleet tick). ~20 array
    ops per rotation keeps the trace small and the semantics explicit."""
    for _ in range(sweeps):
        for p_ in range(n - 1):
            for q_ in range(p_ + 1, n):
                app, aqq, apq = a[p_, p_], a[q_, q_], a[p_, q_]
                small = jnp.abs(apq) < 1e-30
                theta = (aqq - app) / jnp.where(small, 1.0, 2.0 * apq)
                t = jnp.sign(theta) / (jnp.abs(theta) + jnp.sqrt(theta * theta + 1.0))
                t = jnp.where(small, 0.0, t)
                c = 1.0 / jnp.sqrt(t * t + 1.0)
                s_ = t * c
                rp, rq = a[p_], a[q_]
                new_p, new_q = c * rp - s_ * rq, s_ * rp + c * rq
                a = jnp.stack(
                    [new_p if k == p_ else new_q if k == q_ else a[k] for k in range(n)]
                )
                cp, cq = a[:, p_], a[:, q_]
                new_cp, new_cq = c * cp - s_ * cq, s_ * cp + c * cq
                a = jnp.stack(
                    [new_cp if k == p_ else new_cq if k == q_ else a[:, k] for k in range(n)],
                    axis=1,
                )
                vp, vq = v[:, p_], v[:, q_]
                new_vp, new_vq = c * vp - s_ * vq, s_ * vp + c * vq
                v = jnp.stack(
                    [new_vp if k == p_ else new_vq if k == q_ else v[:, k] for k in range(n)],
                    axis=1,
                )
    return a, v


def jacobi_entries(a, n, sweeps: int = 4):
    """Unrolled cyclic Jacobi on a symmetric matrix given as an n×n nested
    list of (batched) scalar arrays (the SoA fleet estimator's layout).
    Returns (w: list n, v: list n×n — columns are eigenvectors).

    Thin wrapper over :func:`_jacobi_stacked_leading`: entries are stacked
    to a (n, n, batch...) array (batch stays minor → lane-dense), rotated,
    and sliced back."""
    a0 = jnp.stack([jnp.stack([a[i][j] for j in range(n)]) for i in range(n)])
    eye_cols = [jnp.broadcast_to(
        jnp.asarray(1.0 if i == j else 0.0, a0.dtype), a0.shape[2:]) for i in range(n)
        for j in range(n)]
    v0 = jnp.stack([jnp.stack(eye_cols[i * n:(i + 1) * n]) for i in range(n)])
    a1, v1 = _jacobi_stacked_leading(a0, v0, n, sweeps)
    w = [a1[i, i] for i in range(n)]
    v = [[v1[i, j] for j in range(n)] for i in range(n)]
    return w, v


def eigh_jacobi_unrolled(s, sweeps: int = 4):
    """(eigenvalues (..., n), eigenvectors (..., n, n)) of symmetric s by
    ``sweeps`` unrolled cyclic Jacobi sweeps — batched, branch-free.

    ``jnp.linalg.eigh`` lowers to a generic batched eigensolver call. For
    n ≤ 6 a fixed number of Jacobi sweeps reaches f32 accuracy with
    n(n−1)/2·sweeps rotations that fuse into the tick. Columns of the
    returned v are eigenvectors: s ≈ v · diag(w) · vᵀ.

    Implemented over :func:`_jacobi_stacked_leading` (see its docstring
    for why the masked-matrix and scalar-entry forms were abandoned):
    the (n, n) pair moves to the leading axes so the batch stays minor.
    """
    n = s.shape[-1]
    a0 = jnp.moveaxis(jnp.asarray(s), (-2, -1), (0, 1))
    v0 = jnp.broadcast_to(
        jnp.eye(n, dtype=a0.dtype).reshape((n, n) + (1,) * (a0.ndim - 2)), a0.shape
    )
    a1, v1 = _jacobi_stacked_leading(a0, v0, n, sweeps)
    w = jnp.moveaxis(jnp.diagonal(a1, axis1=0, axis2=1), -1, -1)  # (..., n)
    v_arr = jnp.moveaxis(v1, (0, 1), (-2, -1))
    return w, v_arr
