"""PANOC solver + condensed QP + PID: correctness vs known optima/oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_rs_jax.controllers.panoc import (
    PanocConfig,
    ball2_projection,
    box_projection,
    make_fd_value_and_grad,
    panoc_solve,
)
from mpc_rs_jax.controllers.pid import PidConfig, pid_init, pid_update
from mpc_rs_jax.controllers.qp import (
    build_condensed_qp,
    create_f_matrix,
    create_g_matrix,
    create_q_matrix,
    make_qp_value_and_grad,
    qp_cost,
    qp_grad,
)
from mpc_rs_jax.models import dynamics, reference
from mpc_rs_jax.models.params import CartPoleParams


def test_panoc_ball2_smoke():
    """op-en2.rs: minimize u0²+u1² on a unit ball → optimum (0,0)."""
    cfg = PanocConfig(tol=1e-6, max_iter=200, lbfgs_mem=10)
    f = lambda u: u[0] ** 2 + u[1] ** 2
    res = panoc_solve(cfg, f, ball2_projection(1.0), jnp.zeros(2))
    assert bool(res.converged)
    np.testing.assert_allclose(np.array(res.u), 0.0, atol=1e-5)


def test_panoc_ball2_active_constraint():
    """Minimum outside the ball → solution on the boundary."""
    cfg = PanocConfig(tol=1e-8, max_iter=300, lbfgs_mem=10)
    target = jnp.asarray([2.0, 2.0])
    f = lambda u: jnp.sum((u - target) ** 2)
    res = panoc_solve(cfg, f, ball2_projection(1.0), jnp.zeros(2))
    u = np.array(res.u)
    np.testing.assert_allclose(u, [np.sqrt(0.5), np.sqrt(0.5)], atol=1e-5)


def test_panoc_box_quadratic():
    """Box-constrained strongly-convex quadratic vs closed-form projection."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 6))
    h = a @ a.T + 6 * np.eye(6)
    b = rng.normal(size=6)
    # unconstrained optimum
    u_star = np.linalg.solve(h, -b)
    # ensure some coordinates exceed the box
    lo, hi = -0.2, 0.2
    f = lambda u: 0.5 * u @ (jnp.asarray(h) @ u) + jnp.asarray(b) @ u
    cfg = PanocConfig(tol=1e-9, max_iter=500, lbfgs_mem=10)
    res = panoc_solve(cfg, f, box_projection(lo, hi), jnp.zeros(6))
    u = np.array(res.u)
    assert bool(res.converged)
    # KKT check: projected gradient vanishes
    g = h @ u + b
    pg = np.clip(u - 0.01 * g, lo, hi) - u
    np.testing.assert_allclose(pg, 0.0, atol=1e-6)
    assert (u >= lo - 1e-12).all() and (u <= hi + 1e-12).all()


def test_panoc_faster_than_pgd_iterations():
    """L-BFGS acceleration: PANOC needs far fewer iterations than its own
    memory-less (≈ projected gradient) variant on an ill-conditioned
    quadratic. (Calibration: scipy L-BFGS-B needs 189 iterations here.)"""
    d = np.geomspace(1.0, 1e4, 20)
    h = jnp.asarray(np.diag(d))
    b = jnp.asarray(np.ones(20))
    f = lambda u: 0.5 * u @ (h @ u) + b @ u
    cfg = PanocConfig(tol=1e-6, max_iter=2000, lbfgs_mem=20)
    res = panoc_solve(cfg, f, box_projection(-10.0, 10.0), jnp.zeros(20))
    assert bool(res.converged)
    cfg1 = PanocConfig(tol=1e-6, max_iter=2000, lbfgs_mem=1)
    res1 = panoc_solve(cfg1, f, box_projection(-10.0, 10.0), jnp.zeros(20))
    assert int(res.iterations) < 400
    assert int(res.iterations) < 0.5 * int(res1.iterations)


def test_fd_gradient_matches_autodiff():
    p = CartPoleParams.single_wheel()
    from mpc_rs_jax.models import costs
    from mpc_rs_jax.utils import as_vector_fn

    step = as_vector_fn(dynamics.make_cartpole_nonlinear(p, 0.01), 4)
    pe = reference.make_planning_err(p.l)
    cost_full = costs.make_tracking_rollout_cost(step, pe, [0.0, 9.2, 16.0, 0.5, 0.0])
    x0 = jnp.asarray([0.5, 0.0, 0.1, 0.0])
    f = lambda u: cost_full(x0, u)
    u = jnp.asarray(np.random.default_rng(1).normal(size=10) * 0.5)
    _, g_ad = jax.value_and_grad(f)(u)
    _, g_fd = make_fd_value_and_grad(f, eps=1e-4)(u)
    np.testing.assert_allclose(np.array(g_fd), np.array(g_ad), rtol=1e-4, atol=1e-5)


def _np_f_g_q(a, b, c, n):
    s = a.shape[0]
    f = np.zeros((s * n, s))
    for i in range(n):
        f[s * i : s * (i + 1)] = np.linalg.matrix_power(a, i + 1)
    g = np.zeros((s * n, n))
    for i in range(n):
        for j in range(i + 1):
            g[s * i : s * (i + 1), j : j + 1] = np.linalg.matrix_power(a, i - j) @ b
    q = np.kron(np.eye(n), c)
    return f, g, q


def test_qp_builders_vs_oracle():
    p = CartPoleParams.single_wheel()
    dt = 0.1
    a, b = dynamics.linear_ab(p, dt)
    a, b = np.array(a), np.array(b)
    c = np.diag([5.0, 5.0, 1.0, 1.0])
    n = 8
    f_np, g_np, q_np = _np_f_g_q(a, b, c, n)
    np.testing.assert_allclose(create_f_matrix(a, n), f_np, rtol=1e-12)
    np.testing.assert_allclose(create_g_matrix(a, b, n), g_np, rtol=1e-12)
    np.testing.assert_allclose(create_q_matrix(c, n), q_np, rtol=1e-12)


def test_qp_cost_grad_consistent():
    p = CartPoleParams.single_wheel()
    a, b = dynamics.linear_ab(p, 0.1)
    c = np.diag([5.0, 5.0, 1.0, 1.0])
    qp = build_condensed_qp(a, b, c, 8)
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(rng.normal(size=4))
    u = jnp.asarray(rng.normal(size=8))
    x_ref = jnp.asarray(rng.normal(size=32))
    g_analytic = qp_grad(qp, x0, u, x_ref)
    g_ad = jax.grad(lambda uu: qp_cost(qp, x0, uu, x_ref))(u)
    np.testing.assert_allclose(np.array(g_analytic), np.array(g_ad), rtol=1e-9)


def test_qp_mpc_closed_loop_parks():
    """op-mpc-x-calc.rs scenario: linear plant + condensed-QP PANOC parks
    the pendulum from x=[0.5,0,0.1,0]."""
    p = CartPoleParams.single_wheel()
    dt = 0.8 / 8
    n = 8
    a, b = dynamics.linear_ab(p, dt)
    c = np.diag([5.0, 5.0, 1.0, 1.0])
    qp = build_condensed_qp(a, b, c, n)
    gen_ref = reference.make_gen_ref_raised_cosine(n)
    vg_factory = make_qp_value_and_grad(qp, gen_ref)
    aj, bj = jnp.asarray(a), jnp.asarray(b).reshape(-1)
    cfg = PanocConfig(tol=1e-6, max_iter=80, lbfgs_mem=20)
    proj = box_projection(-30.0, 30.0)

    @jax.jit
    def tick(x, u):
        res = panoc_solve(cfg, None, proj, u, value_and_grad=vg_factory(x))
        u_new = res.u
        x_new = aj @ x + bj * u_new[0]
        return x_new, u_new, res

    x = jnp.asarray([0.5, 0.0, 0.1, 0.0])
    u = jnp.zeros(n)
    for i in range(60):
        x, u, res = tick(x, u)
        assert abs(float(x[2])) < np.pi / 2, f"tipped at {i}"
    assert abs(float(x[0])) < 0.1
    assert abs(float(x[2])) < 0.05


def test_pid_velocity_form():
    cfg = PidConfig(kp=0.6, ki=0.4, kd=5e-3, lo=-25.0, hi=25.0)
    s = pid_init(dtype=jnp.float64)
    dt = 1e-3
    # first tick: du = kp*e + ki*e*dt + kd*e/dt
    u, s = pid_update(cfg, s, jnp.float64(1.0), jnp.float64(0.0), dt)
    want = 0.6 * 1.0 + 0.4 * 1.0 * dt + 5e-3 * 1.0 / dt
    assert float(u) == pytest.approx(min(want, 25.0))
    # constant error: only the integral term keeps pushing
    u2, s = pid_update(cfg, s, jnp.float64(1.0), jnp.float64(0.0), dt)
    assert float(u2) == pytest.approx(min(float(u) + 0.4 * dt - 5e-3 / dt, 25.0))


def test_pid_linear_pendulum_episode():
    """pid.rs scenario. Note: with Kp=0.6 a positional-equivalent PID cannot
    stabilize this plant (needs loop gain ≳ a32/|b3| ≈ 13), so the reference
    episode ends in the 60° tip-over guard (pid.rs:52-55); we assert the
    same qualitative behavior: finite clamped outputs, unstable divergence
    caught by the guard."""
    p = CartPoleParams.single_wheel()
    dt = 1e-3
    step = dynamics.make_cartpole_linear_pid(p, dt)
    cfg = PidConfig(kp=0.6, ki=0.4, kd=5e-3, lo=-25.0, hi=25.0)
    s = pid_init(dtype=jnp.float64)

    @jax.jit
    def run(x, s):
        def body(carry, i):
            x, s = carry
            phase = jnp.clip(x[0], -0.5, 0.5) * np.pi / 0.5 / 2.0  # pid.rs:24
            theta_ref = -0.2 * jnp.sin(phase) ** 5
            u, s = pid_update(cfg, s, theta_ref, x[2], dt)
            x = jnp.stack(step(x[0], x[1], x[2], x[3], -u))
            return (x, s), jnp.stack([x[2], u])

        return jax.lax.scan(body, (x, s), jnp.arange(2000))

    (x, _), out = run(jnp.asarray([-0.5, 0.0, 0.2, 0.0]), s)
    thetas, us = np.array(out[:, 0]), np.array(out[:, 1])
    assert np.isfinite(us).all() and (np.abs(us) <= 25.0 + 1e-9).all()
    tipped = np.abs(thetas) > np.radians(60.0)
    assert tipped.any(), "expected the under-gained PID baseline to tip over"
    # and the tip-over is not immediate (controller does push back a while)
    assert np.argmax(tipped) > 300


def test_panoc_vmap_batched_scenarios():
    """panoc_solve is vmappable: a batch of box-QPs solved in one call
    matches per-instance solves (the batched gradient-MPC fleet path)."""
    rng = np.random.default_rng(7)
    n, b = 6, 5
    hs = []
    bs = []
    for _ in range(b):
        a = rng.normal(size=(n, n))
        hs.append(a @ a.T + 4 * np.eye(n))
        bs.append(rng.normal(size=n))
    hs, bs = jnp.asarray(np.array(hs)), jnp.asarray(np.array(bs))
    cfg = PanocConfig(tol=1e-8, max_iter=300, lbfgs_mem=10)
    proj = box_projection(-0.5, 0.5)

    def solve_one(h, bvec):
        f = lambda u: 0.5 * u @ (h @ u) + bvec @ u
        return panoc_solve(cfg, f, proj, jnp.zeros(n)).u

    batched = jax.vmap(solve_one)(hs, bs)
    for i in range(b):
        single = solve_one(hs[i], bs[i])
        np.testing.assert_allclose(np.array(batched[i]), np.array(single), atol=1e-6)


def _cartpole_qp(dtype=jnp.float64):
    p = CartPoleParams.single_wheel()
    a, bm = dynamics.linear_ab(p, 0.1)
    c = np.diag([5.0, 5.0, 1.0, 1.0])
    return build_condensed_qp(a, bm, c, 8, dtype=dtype)


def test_box_qp_newton_kkt_exact():
    """box_qp_newton reaches the exact KKT point of the condensed box-QP:
    free-coordinate gradient ~ machine zero, bound multipliers signed
    correctly — even with most coordinates bound-active (tight box)."""
    from mpc_rs_jax.controllers.qp import box_qp_newton, qp_linear_term

    qp = _cartpole_qp()
    gen_ref = reference.make_gen_ref_raised_cosine(8)
    key = jax.random.key(1)
    x0 = jnp.asarray([0.5, 0.0, 0.1, 0.0]) + 1.0 * jax.random.normal(key, (64, 4))
    x_ref = jax.vmap(lambda x: gen_ref(x).reshape(-1))(x0)
    b = qp_linear_term(qp, x0, x_ref)
    lo, hi = -3.0, 3.0
    u = np.array(box_qp_newton(qp.h, b, jnp.zeros((64, 8)), lo, hi, iters=16))
    # active-set inverse-table path (single-instance latency mode): same
    # iterates up to rounding
    from mpc_rs_jax.controllers.qp import active_set_inverse_table

    tbl = active_set_inverse_table(qp.h)
    u_tbl = np.array(
        box_qp_newton(qp.h, b, jnp.zeros((64, 8)), lo, hi, iters=16, inv_table=tbl)
    )
    np.testing.assert_allclose(u_tbl, u, atol=1e-9)
    h = np.array(qp.h)
    g = 2 * u @ h + np.array(b)
    free = (u > lo + 1e-9) & (u < hi - 1e-9)
    assert (~free).any(), "test should exercise active bounds"
    assert np.abs(g * free).max() < 1e-8
    assert (g[np.abs(u - lo) < 1e-9] > -1e-8).all()
    assert (g[np.abs(u - hi) < 1e-9] < 1e-8).all()
    assert (u >= lo - 1e-12).all() and (u <= hi + 1e-12).all()


def test_box_qp_newton_matches_panoc():
    """Same minimizer as panoc_solve on the same strictly convex QP (wide
    box, interior optimum → both converge tightly), f64."""
    from mpc_rs_jax.controllers.qp import box_qp_newton, qp_linear_term

    qp = _cartpole_qp()
    gen_ref = reference.make_gen_ref_raised_cosine(8)
    vgf = make_qp_value_and_grad(qp, gen_ref)
    cfg = PanocConfig(tol=1e-10, max_iter=2000, lbfgs_mem=10)
    proj = box_projection(-300.0, 300.0)
    key = jax.random.key(3)
    x0 = jnp.asarray([0.5, 0.0, 0.1, 0.0]) + 0.3 * jax.random.normal(key, (8, 4))
    x_ref = jax.vmap(lambda x: gen_ref(x).reshape(-1))(x0)
    b = qp_linear_term(qp, x0, x_ref)
    u_n = np.array(box_qp_newton(qp.h, b, jnp.zeros((8, 8)), -300.0, 300.0, iters=12))
    u_p = np.array(
        jax.vmap(lambda x, u: panoc_solve(cfg, None, proj, u, value_and_grad=vgf(x)).u)(
            x0, jnp.zeros((8, 8))
        )
    )
    np.testing.assert_allclose(u_n, u_p, atol=5e-5)


def test_box_qp_newton_jit_vmap_f32():
    """The fleet usage pattern: f32, jitted, batched; solution must satisfy
    KKT to f32 precision and respect the box exactly."""
    from mpc_rs_jax.controllers.qp import box_qp_newton, qp_linear_term

    qp = _cartpole_qp(dtype=jnp.float32)
    gen_ref = reference.make_gen_ref_raised_cosine(8)
    key = jax.random.key(9)
    x0 = (jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32)
          + 0.5 * jax.random.normal(key, (128, 4), jnp.float32))
    x_ref = jax.vmap(lambda x: gen_ref(x).reshape(-1))(x0)
    b = qp_linear_term(qp, x0, x_ref)
    solve = jax.jit(lambda bb, uu: box_qp_newton(qp.h, bb, uu, -30.0, 30.0, iters=12))
    u = np.array(solve(b, jnp.zeros((128, 8), jnp.float32)))
    g = 2 * u @ np.array(qp.h) + np.array(b)
    free = (u > -30.0 + 1e-4) & (u < 30.0 - 1e-4)
    # f32 floor: eps·‖H‖·‖u‖ ≈ 4e-4 at cond(H) ≈ 1.8e3 — residual sits there
    # independent of iters (verified 12/20/32 identical)
    scale = max(1.0, np.abs(g).max())
    assert np.abs(g * free).max() / scale < 2e-4
    assert (np.abs(u) <= 30.0 + 1e-6).all()


# ---------------------------------------------------------------------------
# Solver behavior-class checks vs the reference's optimization_engine PANOC
# (VERDICT r2 #6): γ monotonicity, L-BFGS flush on γ change, descent.
# ---------------------------------------------------------------------------

def _stiff_problem():
    """Cost whose curvature jumps ~100× away from the origin — forces γ
    backtracking mid-trajectory (a Lipschitz re-estimate in the reference
    solver), exercising the flush-on-γ-change path."""
    def f(u):
        soft = 0.5 * jnp.sum(u * u)
        stiff = 50.0 * jnp.sum(jnp.maximum(jnp.abs(u) - 0.5, 0.0) ** 2)
        return soft + stiff + 0.3 * u[0]
    return f


def test_panoc_gamma_never_increases_by_default():
    """Reference behavior class: the Lipschitz estimate only rises, so γ
    only falls. With recovery off, final γ ≤ the γ of a 1-iteration run."""
    f = _stiff_problem()
    proj = box_projection(-2.0, 2.0)
    u0 = jnp.asarray([1.8, -1.7, 1.6, -1.5])
    g_prev = None
    for iters in (1, 3, 6, 12, 25, 50):
        res = panoc_solve(PanocConfig(tol=1e-10, max_iter=iters, lbfgs_mem=8), f, proj, u0)
        g = float(res.gamma)
        if g_prev is not None:
            assert g <= g_prev * (1.0 + 1e-6), (iters, g, g_prev)
        g_prev = g


def test_panoc_cost_monotone_in_budget():
    """FBE descent ⇒ the exit cost is (weakly) decreasing as the iteration
    budget grows — the solver never moves uphill."""
    f = _stiff_problem()
    proj = box_projection(-2.0, 2.0)
    u0 = jnp.asarray([1.8, -1.7, 1.6, -1.5])
    costs = [
        float(panoc_solve(PanocConfig(tol=0.0, max_iter=k, lbfgs_mem=8), f, proj, u0).cost)
        for k in range(1, 16)
    ]
    for a, b in zip(costs, costs[1:]):
        assert b <= a + 1e-6 * abs(a), costs


def test_panoc_flush_and_recovery_reach_same_minimizer():
    """γ-recovery (attempt 2γ every N iters) must not change the fixed
    point — same KKT point as the shrink-only run, and still converges."""
    f = _stiff_problem()
    proj = box_projection(-2.0, 2.0)
    u0 = jnp.asarray([1.8, -1.7, 1.6, -1.5])
    base = panoc_solve(PanocConfig(tol=1e-9, max_iter=400, lbfgs_mem=8), f, proj, u0)
    rec = panoc_solve(
        PanocConfig(tol=1e-9, max_iter=400, lbfgs_mem=8, gamma_recovery_period=7),
        f, proj, u0,
    )
    assert bool(base.converged) and bool(rec.converged)
    np.testing.assert_allclose(np.array(base.u), np.array(rec.u), atol=1e-6)
    # recovery may raise γ back up between stiff regions
    assert float(rec.gamma) >= float(base.gamma) * 0.999


def test_panoc_iterate_count_bands():
    """Iterate-count artifact for the reference workloads' problem shapes
    (op-en2 ball QP; the condensed box-QP of op-mpc-x-calc): superlinear
    L-BFGS should land well under the budget, not ride the cap."""
    # op-en2.rs: min u0²+u1² on a ball — reference smoke test
    res = panoc_solve(
        PanocConfig(tol=1e-6, max_iter=200, lbfgs_mem=10),
        lambda u: u[0] ** 2 + u[1] ** 2, ball2_projection(1.0), jnp.zeros(2),
    )
    assert bool(res.converged) and int(res.iterations) <= 10, int(res.iterations)

    # condensed QP (T=0.8, N=8 single-wheel — op-mpc-x-calc.rs:10-27)
    p = CartPoleParams.single_wheel()
    a, bmat = dynamics.linear_ab(p, 0.1)
    qp = build_condensed_qp(np.asarray(a), np.asarray(bmat), np.diag([5.0, 5.0, 1.0, 1.0]), 8)
    gen_ref = reference.make_gen_ref_raised_cosine(8)
    vg = make_qp_value_and_grad(qp, gen_ref)(jnp.asarray([1.0, 0.0, 0.05, 0.0]))
    res = panoc_solve(
        PanocConfig(tol=1e-6, max_iter=300, lbfgs_mem=10),
        None, box_projection(-30.0, 30.0), jnp.zeros(8), value_and_grad=vg,
    )
    # measured 68 iterations at this tolerance (cond(2GᵀQG) ≈ 1e3); the
    # band asserts "well under the 300 budget", not a perf target
    assert bool(res.converged) and int(res.iterations) <= 120, int(res.iterations)
