"""Condensed-QP matrix builders for horizon-unrolled linear MPC.

Rebuilds src/mpc.rs (create_f_matrix!/create_g_matrix!/create_q_matrix!)
as *precomputed constants*: the reference rebuilds F/G/Q inside every cost
and gradient call (examples/mpc-ukf-s.rs:158-177 — O(N²) matrix powers per
solver iteration); here they are built once at trace/setup time.

Also fixes (by construction) the reference's macro hygiene bug where
``create_g_matrix!`` ignores its ``$b`` argument and captures a literal
``B`` from the call site (src/mpc.rs:20).

Prediction over the horizon: X = F x₀ + G U with
  F = [A; A²; …; Aᴺ]                 (src/mpc.rs:2-11)
  G[i,j] = A^(i−j) B  for j ≤ i      (src/mpc.rs:14-25)
  Q = blockdiag(C, …, C)             (src/mpc.rs:28-36)
Cost (examples/op-mpc-x-calc.rs:73-83):
  J(u) = uᵀGᵀQGu + 2(x₀ᵀFᵀ − x_refᵀ)QGu
Gradient (op-mpc-x-calc.rs:90-98):
  ∇J = 2GᵀQ(Gu + Fx₀ − x_ref)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


def create_f_matrix(a: np.ndarray, n: int) -> np.ndarray:
    """F = [A; A²; …; Aᴺ] — src/mpc.rs:2-11."""
    a = np.asarray(a, dtype=np.float64)
    s = a.shape[0]
    f = np.zeros((s * n, s))
    ai = np.eye(s)
    for i in range(n):
        ai = ai @ a
        f[s * i : s * (i + 1), :] = ai
    return f


def create_g_matrix(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """Lower-block-triangular G with blocks A^(i−j)B — src/mpc.rs:14-25."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64).reshape(a.shape[0], -1)
    s = a.shape[0]
    g = np.zeros((s * n, n))
    powers = [np.eye(s)]
    for _ in range(n - 1):
        powers.append(powers[-1] @ a)
    for i in range(n):
        for j in range(i + 1):
            g[s * i : s * (i + 1), j : j + 1] = powers[i - j] @ b
    return g


def create_q_matrix(c: np.ndarray, n: int) -> np.ndarray:
    """Q = blockdiag(C,…,C) — src/mpc.rs:28-36."""
    c = np.asarray(c, dtype=np.float64)
    s = c.shape[0]
    q = np.zeros((s * n, s * n))
    for i in range(n):
        q[s * i : s * (i + 1), s * i : s * (i + 1)] = c
    return q


class CondensedQp(NamedTuple):
    f: jnp.ndarray  # (sN, s)
    g: jnp.ndarray  # (sN, N)
    q: jnp.ndarray  # (sN, sN)
    h: jnp.ndarray  # GᵀQG (N, N) — precomputed Hessian
    gq: jnp.ndarray  # GᵀQ (N, sN) — precomputed for the gradient


def build_condensed_qp(a, b, c, n: int, dtype=jnp.float64) -> CondensedQp:
    f = create_f_matrix(a, n)
    g = create_g_matrix(a, b, n)
    q = create_q_matrix(c, n)
    h = g.T @ q @ g
    gq = g.T @ q
    as_j = lambda m: jnp.asarray(m, dtype=dtype)
    return CondensedQp(f=as_j(f), g=as_j(g), q=as_j(q), h=as_j(h), gq=as_j(gq))


def qp_cost(qp: CondensedQp, x0, u, x_ref_flat):
    """J(u) — op-mpc-x-calc.rs:73-83. ``x_ref_flat``: (sN,) column-stacked
    per-step references (the reference flattens its 4×N column-major,
    i.e. step-major — identical to stacking (N,4) rows)."""
    gu = qp.g @ u
    fx = qp.f @ x0
    left = u @ (qp.h @ u)
    right = 2.0 * (fx - x_ref_flat) @ (qp.q @ gu)
    return left + right


def qp_grad(qp: CondensedQp, x0, u, x_ref_flat):
    """∇J = 2GᵀQ(Gu + Fx₀ − x_ref) — op-mpc-x-calc.rs:90-98."""
    return 2.0 * (qp.gq @ (qp.g @ u + qp.f @ x0 - x_ref_flat))


def qp_linear_term(qp: CondensedQp, x0, x_ref_flat):
    """b such that J(u) = uᵀHu + bᵀu (+ a u-independent constant) equals
    ``qp_cost``: b = 2GᵀQ(Fx₀ − x_ref) — the affine part of
    op-mpc-x-calc.rs:73-83. Broadcasts over leading batch dims of ``x0``/
    ``x_ref_flat`` (the batched-fleet path computes B linear terms with two
    matmuls instead of B closure evaluations)."""
    fx = x0 @ qp.f.T  # (…, sN)
    return 2.0 * ((fx - x_ref_flat) @ qp.gq.T)  # (…, N)


def active_set_inverse_table(h) -> jnp.ndarray:
    """(2ⁿ, n, n) table of the projected-Newton system inverses, one per
    active-set bitmask (bit i set ⇔ coordinate i bound-active): the free
    block holds inv(2H_FF), active rows/columns are identity. Computed once
    in f64 at setup. Feasible for n ≤ ~12 (n=8: 256·64 floats = 64 KB);
    with it, each Newton iteration is one gather + one
    (n, n) matvec instead of an unrolled masked Cholesky — the win is
    decisive at small batch, where the ~n³/6 unrolled scalar ops are each a
    separate tiny fusion."""
    h2 = 2.0 * np.asarray(h, np.float64)
    n = h2.shape[-1]
    tbl = np.zeros((2**n, n, n))
    for mask in range(2**n):
        act = np.array([(mask >> i) & 1 for i in range(n)], bool)
        m = (~act).astype(np.float64)
        a = np.outer(m, m) * h2 + np.diag(act.astype(np.float64))
        tbl[mask] = np.linalg.inv(a)
    return jnp.asarray(tbl, jnp.asarray(h).dtype)


def box_qp_newton(h, b, u0, lo, hi, *, iters: int = 16, inv_table=None,
                  safeguard: bool = True, safeguard_iters: int = 8):
    """Batched projected-Newton solver for  min uᵀHu + bᵀu,  lo ≤ u ≤ hi.

    Batched replacement for the vmapped PANOC loop in fleet workloads:
    PANOC is general (any differentiable cost) but its while_loop/L-BFGS
    machinery is all sequential small-vector work; for the *condensed QP*
    the Hessian 2H is a known constant, so the two-metric projected Newton
    method (Bertsekas 1982) applies directly — per iteration: identify the
    binding set from the sign of the gradient at the bounds, take an exact
    Newton step on the free block (masked SPD solve, unrolled Cholesky —
    estimators/smallalg.py), clip. Once the active set settles, one step
    lands on the exact KKT point of the reduced problem, so a fixed small
    ``iters`` (static shape, scan-able, vmappable) reaches machine-precision
    stationarity for horizons this size (N ≤ 50). The best-cost iterate is
    returned, making the fixed-budget loop monotone even mid-settling.

    ``safeguard``: the clipped full Newton step can ACTIVE-SET-CYCLE on
    ill-conditioned problems with asymmetric bounds, sticking far from the
    optimum regardless of iters (found by the random-QP property test vs
    the exact enumerator: cost −47.5 vs optimum −68.1 at cond ≈ 1.6e3).
    With ``safeguard=True`` (default) the Newton phase is followed by a
    projected-gradient-arc phase (Cauchy-scaled backtracking steps; the
    8-point factor-4 sweep reaches below the 1/L Lipschitz step for
    cond(H) ≤ ~1.6e4, where a projected-gradient step provably decreases
    from a non-stationary point — so within that range it escapes the
    cycle, and beyond it it still never increases the cost) and a second
    Newton phase to land exactly on the identified set. At a point that is already the KKT optimum both extra phases are
    no-ops (every candidate is clipped back to the same point), so the
    production answer is unchanged — the gate-validated fleet/latency hot
    paths pass ``safeguard=False`` to skip the extra ~1.5x iterations
    their instances were proven not to need (KKT-exactness tests +
    3^N-enumerator cross-validation, tests/test_panoc.py and
    tests/test_native_oracle.py).

    ``h`` is the (N, N) condensed Hessian GᵀQG (shared across the batch);
    ``b``/``u0`` broadcast over leading batch dims. Equivalent solutions to
    ``panoc_solve`` on the same QP (tests/test_panoc.py), ~3 orders of
    magnitude faster per fleet tick at B=1024.

    ``inv_table``: optional precomputed ``active_set_inverse_table(h)`` —
    replaces the masked Cholesky solve with a gather + matvec (identical
    iterates up to rounding; required for low single-instance latency).
    """
    from mpc_rs_jax.estimators.smallalg import spd_solve_unrolled

    dtype = u0.dtype
    h2 = 2.0 * jnp.asarray(h, dtype)
    n = h2.shape[-1]
    eye = jnp.eye(n, dtype=dtype)
    lo = jnp.asarray(lo, dtype)
    hi = jnp.asarray(hi, dtype)
    eps = 1e-6 * (hi - lo)
    b = jnp.asarray(b, dtype)

    def cost(u):
        return jnp.sum(u * (u @ h2) * 0.5 + b * u, axis=-1)

    u0 = jnp.clip(u0, lo, hi)

    bits = jnp.asarray(2 ** np.arange(n), jnp.int32)

    def newton_step(carry, _):
        u, best_u, best_j = carry
        g = u @ h2 + b
        act = ((u <= lo + eps) & (g > 0)) | ((u >= hi - eps) & (g < 0))
        m = jnp.where(act, jnp.asarray(0.0, dtype), jnp.asarray(1.0, dtype))
        if inv_table is not None:
            idx = jnp.sum(act.astype(jnp.int32) * bits, axis=-1)
            a_inv = inv_table[idx]
            d = jnp.einsum("...ij,...j->...i", a_inv, -g * m)
        else:
            a = m[..., :, None] * m[..., None, :] * h2 + (1.0 - m)[..., :, None] * eye
            d = spd_solve_unrolled(a, (-g * m)[..., None])[..., 0]
        u = jnp.clip(u + d, lo, hi)
        j = cost(u)
        better = j < best_j
        best_u = jnp.where(better[..., None], u, best_u)
        best_j = jnp.minimum(j, best_j)
        return (u, best_u, best_j), None

    def pg_step(carry, _):
        u, best_u, best_j = carry
        g = u @ h2 + b
        # Cauchy step of the unconstrained quadratic along −g, then an
        # 8-point backtracking sweep on the projection arc (factors 4⁰…4⁻⁷,
        # smallest ≈ t*/16384 ≲ 1/λ_max for cond(H) up to ~1e4 — below the
        # 1/L Lipschitz step, where a projected-gradient step is guaranteed
        # to decrease from a non-stationary point); keep-if-better semantics
        # make the phase monotone from best_u. For conditioning beyond that
        # range the phase may make no progress in one call (it never makes
        # things worse) — the property test pins cond ≤ 1e4
        # (tests/test_native_oracle.py).
        ghg = jnp.sum(g * (g @ h2), axis=-1)
        t_star = jnp.sum(g * g, axis=-1) / jnp.maximum(ghg, 1e-30)
        cands = jnp.stack([
            jnp.clip(u - (t_star * f)[..., None] * g, lo, hi)
            for f in (1.0, 0.25, 0.0625, 0.015625,
                      0.00390625, 0.0009765625, 0.000244140625, 6.103515625e-05)
        ])
        js = cost(cands)
        pick = jnp.argmin(js, axis=0)
        u_new = jnp.take_along_axis(
            jnp.moveaxis(cands, 0, -2), pick[..., None, None], axis=-2
        )[..., 0, :]
        j_new = jnp.min(js, axis=0)
        take = j_new < best_j
        u = jnp.where(take[..., None], u_new, best_u)
        best_u = u
        best_j = jnp.minimum(j_new, best_j)
        return (u, best_u, best_j), None

    carry = (u0, u0, cost(u0))
    carry, _ = jax.lax.scan(newton_step, carry, None, length=iters)
    if safeguard:
        # restart both phases from the Newton phase's best iterate
        carry = (carry[1], carry[1], carry[2])
        carry, _ = jax.lax.scan(pg_step, carry, None, length=safeguard_iters)
        carry = (carry[1], carry[1], carry[2])
        carry, _ = jax.lax.scan(newton_step, carry, None, length=max(4, iters // 2))
    return carry[1]


def make_qp_value_and_grad(qp: CondensedQp, gen_ref):
    """Closure factory: (x0) → value_and_grad(u) for panoc_solve.

    ``gen_ref(x0) -> (N, s)`` time-major references, flattened row-major to
    match the reference's column-major 4×N flatten (op-mpc-x-calc.rs:80).
    """

    def for_state(x0):
        x_ref_flat = gen_ref(x0).reshape(-1)

        def vg(u):
            return qp_cost(qp, x0, u, x_ref_flat), qp_grad(qp, x0, u, x_ref_flat)

        return vg

    return for_state
