"""PANOC-style box/ball-constrained solver — gradient MPC in JAX.

Replaces the reference's external ``optimization_engine`` 0.9.0 PANOC
(proximal averaged Newton-type method: L-BFGS direction + projected
gradient with a forward-backward-envelope line search), used by every
op-mpc/mpc-ukf example (e.g. examples/op-mpc-x.rs:158-199,
mpc-ukf-s.rs:246-263, op-en2.rs:22-34).

Differences forced by XLA semantics (SURVEY §7 "hard parts"):
- ``with_max_duration`` (wall-clock budget) becomes a **fixed iteration
  budget** ``max_iter`` — wall-clock deadlines are untraceable.
- Errors become status fields; the caller replicates the reference's
  zero-and-retry loop (op-mpc-x.rs:199-218) with ``jnp.where``.

Implementation: adaptive-γ projected gradient with an L-BFGS (two-loop
recursion, fixed memory → static shapes) direction on the fixed-point
residual and an FBE sufficient-decrease line search with τ-halving and a
pure-prox fallback — the PANOC recipe (Stella/Themelis/Sopasakis/Patrinos,
CDC 2017) under ``lax.while_loop``. Everything is vmappable, so thousands
of MPC instances batch across scenarios.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


def box_projection(lo, hi):
    """constraints::Rectangle — op-mpc-x.rs:188."""
    return lambda u: jnp.clip(u, lo, hi)


def ball2_projection(radius: float, center=None):
    """constraints::Ball2 — examples/op-en2.rs:26."""

    def proj(u):
        d = u if center is None else u - center
        norm = jnp.sqrt(jnp.sum(d * d))
        scale = jnp.where(norm > radius, radius / jnp.maximum(norm, 1e-30), 1.0)
        p = d * scale
        return p if center is None else p + center

    return proj


def no_projection():
    return lambda u: u


@dataclasses.dataclass(frozen=True)
class PanocConfig:
    tol: float = 1e-6  # PANOCCache tolerance (op-mpc-x.rs:158)
    max_iter: int = 100  # fixed budget replacing max_duration
    lbfgs_mem: int = 20  # lbfgs_memory (op-mpc-x.rs:159)
    gamma_init: float | None = None  # None → estimate from first gradient
    max_ls: int = 10  # τ-halvings per line search
    sigma: float = 1e-4  # sufficient-decrease coefficient
    # 0 = γ only ever shrinks, the reference solver's behavior class
    # (optimization_engine's PANOC raises its Lipschitz estimate and never
    # lowers it). N > 0 = every N iterations attempt γ ← min(2γ, γ₀): a
    # recovery lever for costs whose stiffness varies along the path — the
    # backtracker immediately re-halves if the local Lipschitz condition
    # disagrees, so the attempt costs one extra f eval per period.
    gamma_recovery_period: int = 0


class LbfgsMem(NamedTuple):
    s: jax.Array  # (m, n) past steps
    y: jax.Array  # (m, n) past residual diffs
    rho: jax.Array  # (m,) 1/(sᵀy), 0 where slot unused
    idx: jax.Array  # int32 next write slot


class PanocResult(NamedTuple):
    u: jax.Array
    iterations: jax.Array  # int32
    converged: jax.Array  # bool
    fpr_norm: jax.Array  # ‖u − T(u)‖∞ / γ at exit
    cost: jax.Array  # f(u) at exit
    gamma: jax.Array  # final step size (Lipschitz estimate: L ≈ 0.95/γ)


def _lbfgs_init(n: int, m: int, dtype) -> LbfgsMem:
    return LbfgsMem(
        s=jnp.zeros((m, n), dtype),
        y=jnp.zeros((m, n), dtype),
        rho=jnp.zeros((m,), dtype),
        idx=jnp.int32(0),
    )


def _lbfgs_direction(mem: LbfgsMem, g: jax.Array) -> jax.Array:
    """Two-loop recursion returning d ≈ −H·g (H ≈ inverse 'Hessian')."""
    m = mem.s.shape[0]
    # iterate from most recent to oldest
    order = (mem.idx - 1 - jnp.arange(m)) % m

    def first_loop(carry, i):
        q, alphas = carry
        rho_i = mem.rho[i]
        alpha = rho_i * jnp.dot(mem.s[i], q)
        q = q - alpha * mem.y[i]
        return (q, alphas), alpha

    (q, _), alphas = jax.lax.scan(first_loop, (g, None), order)
    # initial scaling γ0 = sᵀy/yᵀy of most recent valid pair
    last = (mem.idx - 1) % m
    sy = jnp.dot(mem.s[last], mem.y[last])
    yy = jnp.dot(mem.y[last], mem.y[last])
    h0 = jnp.where(yy > 0, sy / jnp.maximum(yy, 1e-30), 1.0)
    r = h0 * q

    def second_loop(r, args):
        i, alpha = args
        beta = mem.rho[i] * jnp.dot(mem.y[i], r)
        r = r + mem.s[i] * (alpha - beta)
        return r, None

    r, _ = jax.lax.scan(second_loop, r, (order[::-1], alphas[::-1]))
    return -r


def _lbfgs_push(mem: LbfgsMem, s: jax.Array, y: jax.Array) -> LbfgsMem:
    sy = jnp.dot(s, y)
    good = sy > 1e-12 * jnp.sqrt(jnp.dot(s, s) * jnp.dot(y, y))
    rho = jnp.where(good, 1.0 / jnp.where(good, sy, 1.0), 0.0)
    i = mem.idx % mem.s.shape[0]
    new = LbfgsMem(
        s=mem.s.at[i].set(jnp.where(good, s, mem.s[i])),
        y=mem.y.at[i].set(jnp.where(good, y, mem.y[i])),
        rho=mem.rho.at[i].set(jnp.where(good, rho, mem.rho[i])),
        idx=jnp.where(good, mem.idx + 1, mem.idx),
    )
    return new


def panoc_solve(
    cfg: PanocConfig,
    f: Callable | None,
    proj: Callable,
    u0: jax.Array,
    value_and_grad: Callable | None = None,
) -> PanocResult:
    """Minimize f(u) s.t. u ∈ C (via ``proj``) from warm start ``u0``.

    jit-able, vmappable. ``f`` must be jax-differentiable unless
    ``value_and_grad`` is supplied (e.g. a finite-difference oracle for
    parity with op-mpc-x.rs:132-151, or a precomputed QP oracle), in which
    case ``f`` may be None (cost values come from the oracle).
    """
    if value_and_grad is None:
        vg = jax.value_and_grad(f)
        f_eval = f
    else:
        vg = value_and_grad
        # keep cost evaluations consistent with the supplied oracle
        f_eval = f if f is not None else (lambda u: vg(u)[0])
    f = f_eval
    dtype = u0.dtype
    n = u0.shape[-1]

    f0, g0 = vg(u0)
    if cfg.gamma_init is None:
        # conservative local Lipschitz estimate from the first gradient
        gnorm = jnp.sqrt(jnp.sum(g0 * g0))
        gamma0 = jnp.where(gnorm > 0, 0.95 / jnp.maximum(gnorm, 1e-10), 1.0)
        gamma0 = jnp.minimum(gamma0, 1.0).astype(dtype)
    else:
        gamma0 = jnp.asarray(cfg.gamma_init, dtype)

    def fbe(u, f_u, g_u, gamma):
        z = proj(u - gamma * g_u)
        d = z - u
        phi = f_u + jnp.vdot(g_u, d) + jnp.sum(d * d) / (2 * gamma)
        return phi, z

    def backtrack_gamma(u, f_u, g_u, gamma):
        """Halve γ until the local descent (Lipschitz) condition holds."""

        def cond(state):
            gamma, _, k = state
            z = proj(u - gamma * g_u)
            d = z - u
            fz = f(z)
            viol = fz > f_u + jnp.vdot(g_u, d) + jnp.sum(d * d) / (2 * gamma) + 1e-10 * jnp.abs(f_u)
            return jnp.logical_and(viol, k < 40)

        def body(state):
            gamma, z, k = state
            gamma = gamma * 0.5
            return gamma, proj(u - gamma * g_u), k + 1

        z0 = proj(u - gamma * g_u)
        gamma, z, _ = jax.lax.while_loop(cond, body, (gamma, z0, jnp.int32(0)))
        return gamma, z

    class Carry(NamedTuple):
        u: jax.Array
        f_u: jax.Array
        g_u: jax.Array
        gamma: jax.Array
        mem: LbfgsMem
        it: jax.Array
        converged: jax.Array
        fpr: jax.Array

    def cond(c: Carry):
        return jnp.logical_and(c.it < cfg.max_iter, jnp.logical_not(c.converged))

    def body(c: Carry):
        gamma_try = c.gamma
        if cfg.gamma_recovery_period > 0:
            period = cfg.gamma_recovery_period
            recover = (c.it % period) == (period - 1)
            gamma_try = jnp.where(recover, jnp.minimum(2.0 * c.gamma, gamma0), c.gamma)
        gamma, z = backtrack_gamma(c.u, c.f_u, c.g_u, gamma_try)
        r = c.u - z  # γ·R(u)
        fpr = jnp.max(jnp.abs(r)) / gamma
        converged = fpr <= cfg.tol

        # γ changed ⇒ the fixed-point residual changes scale and the stored
        # (s, y) curvature pairs describe a different operator: flush the
        # L-BFGS memory, as the reference solver class does on a Lipschitz
        # re-estimate (zeroing s/y also resets the h0 = sᵀy/yᵀy scaling).
        changed = gamma != c.gamma
        mem = LbfgsMem(
            s=jnp.where(changed, 0.0, c.mem.s),
            y=jnp.where(changed, 0.0, c.mem.y),
            rho=jnp.where(changed, 0.0, c.mem.rho),
            idx=jnp.where(changed, jnp.int32(0), c.mem.idx),
        )

        phi_u = c.f_u + jnp.vdot(c.g_u, z - c.u) + jnp.sum(r * r) / (2 * gamma)
        d = _lbfgs_direction(mem, r)

        # τ line search: u⁺ = u − (1−τ)r + τd, τ ∈ {1, ½, …}; fallback τ=0 ⇒ z
        def ls_body(ls):
            tau, best_u, best_phi, accepted, k = ls
            u_try = c.u - (1.0 - tau) * r + tau * d
            f_try, g_try = vg(u_try)
            phi_try, _ = fbe(u_try, f_try, g_try, gamma)
            ok = phi_try <= phi_u - cfg.sigma * jnp.sum(r * r) / gamma
            best_u = jnp.where(ok & ~accepted, u_try, best_u)
            best_phi = jnp.where(ok & ~accepted, phi_try, best_phi)
            return tau * 0.5, best_u, best_phi, accepted | ok, k + 1

        def ls_cond(ls):
            _, _, _, accepted, k = ls
            return jnp.logical_and(~accepted, k < cfg.max_ls)

        tau0 = jnp.asarray(1.0, dtype)
        _, u_new, _, accepted, _ = jax.lax.while_loop(
            ls_cond, ls_body, (tau0, z, phi_u, jnp.bool_(False), jnp.int32(0))
        )
        u_new = jnp.where(accepted, u_new, z)  # prox fallback always decreases
        u_new = jnp.where(converged, c.u, u_new)

        f_new, g_new = vg(u_new)
        z_new = proj(u_new - gamma * g_new)
        r_new = u_new - z_new
        mem = _lbfgs_push(mem, u_new - c.u, r_new - r)

        return Carry(
            u=u_new,
            f_u=f_new,
            g_u=g_new,
            gamma=gamma,
            mem=mem,
            it=c.it + 1,
            converged=converged,
            fpr=fpr,
        )

    init = Carry(
        u=u0,
        f_u=f0,
        g_u=g0,
        gamma=gamma0,
        mem=_lbfgs_init(n, cfg.lbfgs_mem, dtype),
        it=jnp.int32(0),
        converged=jnp.bool_(False),
        fpr=jnp.asarray(jnp.inf, dtype),
    )
    out = jax.lax.while_loop(cond, body, init)
    return PanocResult(
        u=out.u,
        iterations=out.it,
        converged=out.converged,
        fpr_norm=out.fpr,
        cost=out.f_u,
        gamma=out.gamma,
    )


def make_fd_value_and_grad(f: Callable, eps: float = 1e-3):
    """Plain central-difference gradient of ``f`` itself, vmapped over
    components (EPS matches op-mpc-x.rs:131). NOTE this is the textbook
    scheme, not the reference's — see ``make_shifted_fd_value_and_grad``
    for the exact op-mpc-x.rs:132-151 semantics. Prefer jax.grad in
    production (SURVEY §2d)."""

    def vg(u):
        n = u.shape[-1]
        eye = jnp.eye(n, dtype=u.dtype) * eps
        f_pos = jax.vmap(lambda e: f(u + e))(eye)
        f_neg = jax.vmap(lambda e: f(u - e))(eye)
        return f(u), (f_pos - f_neg) / (2 * eps)

    return vg


def make_shifted_fd_value_and_grad(cost_from_state: Callable, step: Callable,
                                   eps: float = 1e-3):
    """The reference's numeric gradient, transcribed EXACTLY —
    op-mpc-x.rs:132-151: each component i differentiates the cost evaluated
    from ``dynamics_cpy(x, u[i])`` (the state pre-stepped once by u[i]),
    not from x itself. The returned df is therefore inconsistent with f by
    one plant step per component — an idiosyncrasy of the reference that
    its PANOC retry loop absorbs; replicated here behind the ``--fd``
    parity flag (cross-validated against native/oracle.cpp).

    ``cost_from_state(x, u) -> scalar``; ``step(x, u) -> x`` vector form.
    Returns ``vg(x) -> (u) -> (f(u), df(u))`` with f(u) = cost_from_state(x, u).
    """

    def make(x):
        def vg(u):
            n = u.shape[-1]
            eye = jnp.eye(n, dtype=u.dtype) * eps
            x_pre = jax.vmap(lambda ui: step(x, ui))(u)  # (N, S) — :135-136

            def comp(xi, e):
                return cost_from_state(xi, u + e) - cost_from_state(xi, u - e)

            grad = jax.vmap(comp)(x_pre, eye) / (2 * eps)
            return cost_from_state(x, u), grad

        return vg

    return make
