"""Batch-minor (SoA) UKF vs the reference AoS implementation.

The SoA path must be numerically equivalent (same algorithm, same rotation
sequence — only f32 op-order differs) and its equilibrated unrolled gain
solve must match a pivoted f64 solve on the flagship's ill-conditioned Pz
(variance scales 4e4 vs 2.5e-3 — the case that broke the UNequilibrated
unrolled solve, estimators/ukf.py:168-178)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_rs_jax.estimators import ukf_soa
from mpc_rs_jax.estimators.ukf import ukf_init, ukf_predict, ukf_update


def _component_fx(dt=0.01):
    def fx(xs, u):
        x0, x1, x2, x3 = xs
        return (x0 + x1 * dt, x1 + u * dt, x2 + x3 * dt, x3 - 0.5 * jnp.sin(x2) * dt)

    return fx


def _component_hx():
    def hx(xs):
        return (17.0 * xs[1], xs[3] * 57.29578, xs[0] + 0.1 * jnp.cos(xs[2]))

    return hx


def _vector_fx(dt=0.01):
    cfx = _component_fx(dt)

    def fx(x, u):
        out = cfx(tuple(x[..., i] for i in range(4)), u)
        return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

    return fx


def _vector_hx():
    chx = _component_hx()

    def hx(x):
        out = chx(tuple(x[..., i] for i in range(4)))
        return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

    return hx


def _random_spd(rng, b, n, scale=1.0):
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    return scale * (a @ a.transpose(0, 2, 1)) + 0.1 * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("sqrt_method", ["jacobi"])
def test_soa_step_matches_aos(sqrt_method):
    """Algorithm equality in f64, UNJITTED (tight ~1e-12): the two layouts
    implement the same update. Under jit this comparison is NOT valid for
    nonlinear fx/hx: XLA's FMA contraction perturbs the Jacobi at
    near-degenerate eigenvalues, rotating eigenvectors within the
    degenerate subspace — a different but equally valid matrix square
    root, and the UT is only sqrt-invariant through linear maps (same
    reason the jacobi-vs-eigh tests in test_ukf.py use moment contracts
    and linear-model equality). test_soa_jit_linear_matches_aos covers
    the jitted path."""
    rng = np.random.default_rng(0)
    b, n, o = 16, 4, 3
    q = 0.01 * np.eye(n, dtype=np.float64)
    r = np.diag([50.0, 0.5, 0.1]).astype(np.float64)
    params, _ = ukf_init(np.zeros(n, np.float64), np.eye(n, dtype=np.float64), q, r,
                         sqrt_method=sqrt_method)
    x0 = rng.normal(size=(b, n))
    p0 = _random_spd(rng, b, n, 0.05).astype(np.float64)
    z = rng.normal(size=(b, o)) * np.array([30.0, 5.0, 1.0])
    u = rng.normal(size=(b,))

    # AoS: vmapped predict+update
    from mpc_rs_jax.estimators.ukf import UkfState

    m = 2 * n + 1
    aos = UkfState(
        x=jnp.asarray(x0), p=jnp.asarray(p0),
        q=jnp.broadcast_to(jnp.asarray(q), (b, n, n)),
        r=jnp.broadcast_to(jnp.asarray(r), (b, o, o)),
        sigma_f=jnp.zeros((b, m, n), jnp.float64),
    )
    vfx, vhx = _vector_fx(), _vector_hx()

    def aos_step(s, uu, zz):
        s = ukf_predict(params, s, uu, vfx)
        return ukf_update(params, s, zz, vhx)

    out_aos = jax.vmap(aos_step)(aos, jnp.asarray(u), jnp.asarray(z))

    # SoA (unjitted — see docstring)
    soa = ukf_soa.from_batched(jnp.asarray(x0), jnp.asarray(p0), jnp.zeros((b, m, n), jnp.float64))

    def soa_step(s, uu, zz):
        s = ukf_soa.soa_predict(params, s, uu, _component_fx(), q)
        return ukf_soa.soa_update(params, s, tuple(zz[:, j] for j in range(o)),
                                  _component_hx(), r)

    out_soa = soa_step(soa, jnp.asarray(u), jnp.asarray(z))
    x_soa, p_soa, sf_soa = ukf_soa.to_batched(out_soa)

    np.testing.assert_allclose(np.array(x_soa), np.array(out_aos.x), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.array(p_soa), np.array(out_aos.p), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.array(sf_soa), np.array(out_aos.sigma_f), rtol=1e-9, atol=1e-9)


def test_equilibrated_solve_matches_f64_pivoted():
    """Flagship-like Pz: diag scales 4e4 … 2.5e-3 (cond ~1e7 by scale).
    The equilibrated unrolled f32 Cholesky gain must match the pivoted
    solve done in f64 to ≤1e-3 relative — the UNequilibrated unrolled f32
    solve loses the small channels entirely (survival 0.23, ukf.py note)."""
    rng = np.random.default_rng(3)
    b, o = 64, 5
    scales = np.array([4e4, 4e4, 1e2, 2.5e-3, 2.5e-3], np.float64)
    c = rng.normal(size=(b, o, o))
    corr = np.eye(o) + 0.3 * (c + c.transpose(0, 2, 1)) / np.sqrt(o)
    # make correlation-like SPD, then scale rows/cols
    corr = corr @ corr.transpose(0, 2, 1)
    d = np.sqrt(np.einsum("bii->bi", corr))
    corr /= d[:, :, None] * d[:, None, :]
    pz64 = corr * np.sqrt(scales)[None, :, None] * np.sqrt(scales)[None, None, :]
    rhs64 = rng.normal(size=(b, o)) * np.sqrt(scales)

    want = np.linalg.solve(pz64, rhs64[..., None])[..., 0]

    pz32 = [[jnp.asarray(pz64[:, i, j], jnp.float32) for j in range(o)] for i in range(o)]
    rhs32 = [jnp.asarray(rhs64[:, i], jnp.float32) for i in range(o)]
    (sol,) = ukf_soa._chol_solve_equilibrated(pz32, [rhs32], o)
    got = np.stack([np.array(s, np.float64) for s in sol], axis=-1)
    rel = np.abs(got - want) / (np.abs(want) + 1e-12)
    assert rel.max() < 2e-3, rel.max()


def test_soa_guard_resets_bad_instances():
    n = 3
    b = 4
    x = tuple(jnp.where(jnp.arange(b) == 1, jnp.nan, 1.0) for _ in range(n))
    p = tuple(tuple(jnp.ones(b) for _ in range(n)) for _ in range(n))
    # component-stacked sigma_f: n arrays of (m, B)
    sf = tuple(jnp.zeros((2 * n + 1, b)) for _ in range(n))
    out = ukf_soa.soa_guard(ukf_soa.SoaUkfState(x, p, sf), 0.5 * np.eye(n))
    xb, pb, _ = ukf_soa.to_batched(out)
    assert np.isfinite(np.array(xb)).all()
    np.testing.assert_allclose(np.array(pb)[1], 0.5 * np.eye(n), atol=0)
    np.testing.assert_allclose(np.array(pb)[0], np.ones((n, n)), atol=0)


def test_soa_roundtrip_layout():
    rng = np.random.default_rng(1)
    b, n, m = 8, 4, 9
    x = rng.normal(size=(b, n)).astype(np.float32)
    p = rng.normal(size=(b, n, n)).astype(np.float32)
    sf = rng.normal(size=(b, m, n)).astype(np.float32)
    xb, pb, sfb = ukf_soa.to_batched(ukf_soa.from_batched(*map(jnp.asarray, (x, p, sf))))
    np.testing.assert_array_equal(np.array(xb), x)
    np.testing.assert_array_equal(np.array(pb), p)
    np.testing.assert_array_equal(np.array(sfb), sf)


def test_soa_jit_linear_matches_aos():
    """Jitted SoA vs jitted AoS on a LINEAR model: the UT is invariant to
    the sigma square-root through linear maps, so compiler-level FMA
    rounding in the Jacobi cannot leak into the result — both jitted
    pipelines must agree tightly in f64 even at degenerate eigenvalues."""
    rng = np.random.default_rng(7)
    b, n, o = 32, 4, 3
    dt = 0.02
    fmat = np.eye(n) + dt * rng.normal(size=(n, n)) * 0.3
    hmat = rng.normal(size=(o, n))
    q = 0.01 * np.eye(n)
    r = np.diag([2.0, 0.5, 0.1])
    params, _ = ukf_init(np.zeros(n, np.float64), np.eye(n), q, r, sqrt_method="jacobi")
    x0 = rng.normal(size=(b, n))
    p0 = _random_spd(rng, b, n, 0.05).astype(np.float64)
    # include an exactly-degenerate covariance (worst case for sqrt choice)
    p0[0] = 0.3 * np.eye(n)
    z = rng.normal(size=(b, o))
    u = rng.normal(size=(b,))

    def cfx(xs, uu):
        return tuple(sum(fmat[i, j] * xs[j] for j in range(n)) + (0.1 * uu if i == 1 else 0.0)
                     for i in range(n))

    def chx(xs):
        return tuple(sum(hmat[i, j] * xs[j] for j in range(n)) for i in range(o))

    def vfx(x, uu):
        return jnp.stack(jnp.broadcast_arrays(*cfx(tuple(x[..., i] for i in range(n)), uu)), axis=-1)

    def vhx(x):
        return jnp.stack(jnp.broadcast_arrays(*chx(tuple(x[..., i] for i in range(n)))), axis=-1)

    from mpc_rs_jax.estimators.ukf import UkfState

    m = 2 * n + 1
    aos = UkfState(
        x=jnp.asarray(x0), p=jnp.asarray(p0),
        q=jnp.broadcast_to(jnp.asarray(q), (b, n, n)),
        r=jnp.broadcast_to(jnp.asarray(r), (b, o, o)),
        sigma_f=jnp.zeros((b, m, n), jnp.float64),
    )
    out_aos = jax.jit(jax.vmap(lambda s, uu, zz: ukf_update(
        params, ukf_predict(params, s, uu, vfx), zz, vhx)))(aos, jnp.asarray(u), jnp.asarray(z))

    soa = ukf_soa.from_batched(jnp.asarray(x0), jnp.asarray(p0), jnp.zeros((b, m, n), jnp.float64))

    @jax.jit
    def soa_step(s, uu, zz):
        s = ukf_soa.soa_predict(params, s, uu, cfx, q)
        return ukf_soa.soa_update(params, s, tuple(zz[:, j] for j in range(o)), chx, r)

    x_soa, p_soa, _ = ukf_soa.to_batched(soa_step(soa, jnp.asarray(u), jnp.asarray(z)))
    np.testing.assert_allclose(np.array(x_soa), np.array(out_aos.x), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.array(p_soa), np.array(out_aos.p), rtol=1e-7, atol=1e-9)


def test_soa_sigma_moment_contract():
    """SoA sigma points satisfy the UT moment contract for ANY valid sqrt:
    Σ wm σ = x and Σ wc (σ−x)(σ−x)ᵀ = C-scaled P reconstruction (the same
    invariant the jacobi root is pinned by in test_ukf.py) — jitted, f32."""
    rng = np.random.default_rng(11)
    b, n = 64, 6
    p0 = _random_spd(rng, b, n, 0.2)
    x0 = rng.normal(size=(b, n)).astype(np.float32)
    params, _ = ukf_init(np.zeros(n, np.float32), np.eye(n, dtype=np.float32),
                         np.eye(n, dtype=np.float32), np.eye(n, dtype=np.float32),
                         sqrt_method="jacobi")

    @jax.jit
    def pts_fn(x, p):
        soa = ukf_soa.from_batched(x, p, jnp.zeros((b, 2 * n + 1, n), jnp.float32))
        pts = ukf_soa._sigma_points_soa(params.c, soa.x, soa.p, n)
        return jnp.stack([jnp.stack(pt, axis=-1) for pt in pts], axis=1)

    sp = np.array(pts_fn(jnp.asarray(x0), jnp.asarray(p0)), np.float64)  # (b, m, n)
    # mean reconstruction: ± pairs cancel exactly around the center
    np.testing.assert_allclose(sp[:, 1:n + 1] + sp[:, n + 1:] - 2 * sp[:, :1],
                               np.zeros_like(sp[:, 1:n + 1]), atol=1e-4)
    # covariance reconstruction: Σᵢ δᵢδᵢᵀ = C·P (deltas are ±rows of sqrt(C·P))
    d = sp[:, 1:n + 1] - sp[:, :1]
    rec = np.einsum("bms,bmt->bst", d, d)
    np.testing.assert_allclose(rec, float(params.c) * p0.astype(np.float64),
                               rtol=2e-3, atol=2e-4)
