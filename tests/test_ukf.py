"""UKF vs a NumPy f64 oracle (SVD sigma points, as the reference uses)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_rs_jax.estimators.gaussian import Gaussian, kf1d_predict, kf1d_update_explicit
from mpc_rs_jax.estimators.kf import kf_predict, kf_update, kf_update_joseph
from mpc_rs_jax.estimators.ukf import merwe_weights, sigma_points, ukf_init, ukf_predict, ukf_update
from mpc_rs_jax.models import dynamics, observation
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.utils import as_vector_fn


class NpUkf:
    """Oracle transcription of src/ukf.rs (SVD square root, f64)."""

    def __init__(self, x, p, q, r, alpha=1e-3, beta=2.0):
        self.n = len(x)
        self.x, self.p, self.q, self.r = map(np.array, (x, p, q, r))
        n = float(self.n)
        kappa = 3.0 - n
        self.c = alpha**2 * (n + kappa)
        lam = self.c - n
        m = 2 * self.n + 1
        self.wm = np.full(m, 1.0 / (2 * self.c))
        self.wc = np.full(m, 1.0 / (2 * self.c))
        self.wm[0] = lam / self.c
        self.wc[0] = lam / self.c + 1 - alpha**2 + beta
        self.sigma_f = None

    def _sigma_points(self):
        u, s, _ = np.linalg.svd(self.c * self.p)
        l = u @ np.diag(np.sqrt(s))
        pts = [self.x]
        for i in range(self.n):
            pts.append(self.x + l[:, i])
        for i in range(self.n):
            pts.append(self.x - l[:, i])
        return np.array(pts)

    def _ut(self, sigmas, cov):
        x = self.wm @ sigmas
        y = sigmas - x
        p = (self.wc[:, None] * y).T @ y + cov
        return x, p

    def predict(self, u, fx):
        sig = self._sigma_points()
        self.sigma_f = np.array([fx(s, u) for s in sig])
        self.x, self.p = self._ut(self.sigma_f, self.q)

    def update(self, z, hx):
        sigmas_h = np.array([hx(s) for s in self.sigma_f])
        zp, pz = self._ut(sigmas_h, self.r)
        pxz = (self.wc[:, None] * (self.sigma_f - self.x)).T @ (sigmas_h - zp)
        k = pxz @ np.linalg.inv(pz)
        self.x = self.x + k @ (z - zp)
        self.p = self.p - k @ pz @ k.T
        self.p = (self.p + self.p.T) / 2


def test_merwe_weights_vs_reference_constants():
    wm, wc, c = merwe_weights(4, dtype=jnp.float64)
    # src/ukf.rs:23-28 with N=4: C = 1e-6*(4+(3-4)) = 3e-6
    assert float(c) == pytest.approx(3e-6)
    assert float(wm[0]) == pytest.approx((3e-6 - 4) / 3e-6)
    assert float(wc[0]) == pytest.approx((3e-6 - 4) / 3e-6 + 1 - 1e-6 + 2.0)
    assert float(wm[1]) == pytest.approx(1.0 / 6e-6)
    np.testing.assert_allclose(np.sum(np.array(wm)), 1.0, rtol=1e-9)


def test_sigma_points_reconstruct_moments():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(4, 4))
    p = a @ a.T + 0.5 * np.eye(4)
    x = rng.normal(size=4)
    from mpc_rs_jax.estimators.ukf import UkfParams

    wm, wc, c = merwe_weights(4, dtype=jnp.float64)
    params = UkfParams(wm=wm, wc=wc, c=c, n=4, n_obs=2)
    sig = np.array(sigma_points(params, jnp.asarray(x), jnp.asarray(p)))
    assert sig.shape == (9, 4)
    mean = np.array(wm) @ sig
    np.testing.assert_allclose(mean, x, atol=1e-9)
    y = sig - mean
    pr = (np.array(wc)[:, None] * y).T @ y
    np.testing.assert_allclose(pr, p, rtol=1e-6, atol=1e-9)


def test_ukf_matches_numpy_oracle_cartpole():
    p = CartPoleParams.single_wheel()
    dt = 0.01
    fx = as_vector_fn(dynamics.make_cartpole_nonlinear(p, dt), 4)
    hx = observation.make_hx_rpm_gyro4(p)
    q = np.diag([0.0, 0.0, 0.0, 0.25])
    r = np.diag([100.0, 100.0, 0.5])
    p0 = np.eye(4) * 10.0
    x0 = np.zeros(4)

    params, state = ukf_init(jnp.asarray(x0), jnp.asarray(p0), jnp.asarray(q), jnp.asarray(r))
    oracle = NpUkf(x0, p0, q, r)

    def np_fx(x, u):
        return np.array(fx(jnp.asarray(x), u))

    def np_hx(x):
        return np.array(hx(jnp.asarray(x)))

    rng = np.random.default_rng(0)
    u = 0.1
    x_act = np.zeros(4)
    for i in range(15):
        x_act = np_fx(x_act, u)
        z = np_hx(x_act) + rng.normal(size=3) * [100, 100, 0.5]
        state = ukf_predict(params, state, u, fx)
        state = ukf_update(params, state, jnp.asarray(z), hx)
        oracle.predict(u, np_fx)
        oracle.update(z, np_hx)
        # eigh vs SVD square roots agree only to ~1e-6 once amplified by the
        # O(1e6) Merwe center weights (α=1e-3), and the open-loop pendulum is
        # unstable, so divergence compounds per step; tolerance-band parity as
        # in BASELINE.md ("bit-tolerant match")
        tol = 1e-4 if i < 10 else 3e-3
        np.testing.assert_allclose(np.array(state.x), oracle.x, rtol=tol, atol=max(tol * 0.01, 1e-4))
        np.testing.assert_allclose(np.array(state.p), oracle.p, rtol=10 * tol, atol=max(tol * 0.01, 1e-4))

    # covariance stays symmetric PSD
    pf = np.array(state.p)
    np.testing.assert_allclose(pf, pf.T)
    assert np.linalg.eigvalsh(pf).min() > -1e-10


def test_ukf_set_q_set_r():
    params, state = ukf_init(jnp.zeros(6), jnp.eye(6), jnp.eye(6), jnp.eye(5))
    q2 = 2.0 * jnp.eye(6)
    r2 = 3.0 * jnp.eye(5)
    state = state._replace(q=q2, r=r2)  # set_q (ukf2.rs:96-98) + the missing set_r
    np.testing.assert_allclose(np.array(state.q), 2 * np.eye(6))
    np.testing.assert_allclose(np.array(state.r), 3 * np.eye(5))


def test_ukf_vmap_batch_equals_loop():
    p = CartPoleParams.single_wheel()
    fx = as_vector_fn(dynamics.make_cartpole_nonlinear(p, 0.01), 4)
    hx = observation.make_hx_rpm_gyro4(p)
    q = jnp.diag(jnp.asarray([0.0, 0.0, 0.0, 0.25]))
    r = jnp.diag(jnp.asarray([100.0, 100.0, 0.5]))
    params, s0 = ukf_init(jnp.zeros(4), 10 * jnp.eye(4), q, r)

    rng = np.random.default_rng(2)
    xs = jnp.asarray(rng.normal(size=(5, 4)) * 0.1)
    zs = jnp.asarray(rng.normal(size=(5, 3)))
    us = jnp.asarray(rng.normal(size=(5,)))

    batched = jax.vmap(lambda x, p_, z, u: ukf_update(
        params, ukf_predict(params, s0._replace(x=x, p=p_), u, fx), z, hx
    ), in_axes=(0, None, 0, 0))(xs, s0.p, zs, us)

    for i in range(5):
        si = ukf_update(params, ukf_predict(params, s0._replace(x=xs[i]), us[i], fx), zs[i], hx)
        np.testing.assert_allclose(np.array(batched.x[i]), np.array(si.x), rtol=1e-9)
        np.testing.assert_allclose(np.array(batched.p[i]), np.array(si.p), rtol=1e-9)


def test_linear_kf_joseph_vs_textbook():
    # examples/two-liner-kf.rs constants
    dt = 0.01
    f = jnp.asarray([[1.0, dt], [0.0, 1.0]])
    q = jnp.asarray([[0.25, 0.5], [0.5, 1.0]])
    h = jnp.asarray([[1.0, 0.0]])
    r = jnp.asarray([[4.0]])
    b = jnp.asarray([[0.0, 0.0], [1.0, -1.0]])
    x = jnp.zeros(2)
    p = 100.0 * jnp.eye(2)
    u = jnp.asarray([0.5, -0.5])
    x, p = kf_predict(x, p, f, q, u, b)
    z = jnp.asarray([0.3])
    x1, p1 = kf_update_joseph(x, p, z, h, r)
    x2, p2 = kf_update(x, p, z, h, r)
    np.testing.assert_allclose(np.array(x1), np.array(x2), rtol=1e-9)
    np.testing.assert_allclose(np.array(p1), np.array(p2), rtol=1e-7)
    assert np.allclose(np.array(p1), np.array(p1).T)


def test_gaussian_algebra():
    a = Gaussian(jnp.float64(10.0), jnp.float64(10.0))
    b = Gaussian(jnp.float64(0.5), jnp.float64(1.0))
    s = a + b
    assert float(s.mean) == pytest.approx(10.5)
    assert float(s.var) == pytest.approx(11.0)
    prod = a * b
    want_mean = (10.0 * 0.5 + 1.0 * 10.0) / 11.0
    assert float(prod.mean) == pytest.approx(want_mean)
    assert float(prod.var) == pytest.approx(10.0 / 11.0)
    # product form equals explicit-gain form (one-liner-kf.rs:26-40)
    e = kf1d_update_explicit(a, b)
    assert float(e.mean) == pytest.approx(float(prod.mean))
    assert float(e.var) == pytest.approx(float(prod.var))
    scaled = a * 2.0
    assert float(scaled.mean) == pytest.approx(20.0)
    # 1-D KF converges from wrong prior (one-liner-kf.rs scenario)
    x_est = Gaussian(jnp.float64(10.0), jnp.float64(10.0))
    x_act = 0.0
    rng = np.random.default_rng(3)
    for _ in range(100):
        x_act += 0.5
        x_est = kf1d_predict(x_est, Gaussian(jnp.float64(0.5), jnp.float64(1.0)))
        obs = Gaussian(jnp.float64(x_act + rng.normal() * 2.0), jnp.float64(4.0))
        x_est = x_est * obs
    assert abs(float(x_est.mean) - x_act) < 2.0
    assert float(x_est.var) < 2.0


def test_ukf_f32_no_catastrophic_cancellation():
    """The f32 path must stay finite with alpha=1e-3 center weights
    (the naive UT mean NaNs within ~100 steps on a 6-state filter)."""
    p = CartPoleParams.single_wheel()
    fx = as_vector_fn(dynamics.make_pen6(p, 0.01), 6)
    from mpc_rs_jax.models.observation import make_hx_force6

    hx = make_hx_force6(p)
    q = jnp.diag(jnp.asarray([0, 0, 0, 0, 0, 10.0], jnp.float32))
    r = jnp.diag(jnp.asarray([100.0, 100.0, 0.5, 100.0, 100.0], jnp.float32))
    params, s = ukf_init(jnp.zeros(6, jnp.float32), 10.0 * jnp.eye(6, dtype=jnp.float32), q, r)
    rng = np.random.default_rng(0)
    x_act = np.zeros(6)
    for i in range(100):
        x_act = np.array(fx(jnp.asarray(x_act, jnp.float64), 0.1))
        z = np.array(hx(jnp.asarray(x_act))) + rng.normal(size=5) * [100, 100, 0.5, 100, 100]
        s = ukf_predict(params, s, jnp.float32(0.1), fx)
        s = ukf_update(params, s, jnp.asarray(z, jnp.float32), hx)
        assert np.isfinite(np.array(s.x)).all(), f"NaN at step {i}"
        assert np.isfinite(np.array(s.p)).all(), f"NaN P at step {i}"


def test_ukf_jacobi_sigma_root_moment_contract():
    """The defining contract of ANY sigma root: identity-UT over the sigma
    set reconstructs (x, P) exactly. The unrolled-Jacobi root
    (smallalg.eigh_jacobi_unrolled, the elementwise fleet option) must satisfy it to
    its decomposition residual (~1e-5 of scale in f32), matching eigh.

    Filter-level nonlinear per-step comparison is deliberately NOT tested:
    the flagship measurement update amplifies 1e-6 P perturbations by up to
    1e4 (measured: eigh-vs-eigh with 1e-6-perturbed P moves the state by up
    to 2.6e-2 of scale), so any tolerance tight enough to be meaningful
    fails for eigh against itself. Nonlinear closed-loop equivalence is
    evidenced at the survival level instead (flagship fleet, B=1024,
    seeds 0-3: jacobi 4094/4096 scenario-survivals, per-seed identical to
    exact eigh — the two tipped scenarios tip under BOTH roots, so they
    are the operating point's, not the root's; DESIGN.md §5)."""
    from mpc_rs_jax.estimators.ukf import sigma_points, unscented_transform

    rng = np.random.default_rng(7)
    for trial in range(20):
        x0 = jnp.asarray(rng.normal(size=6) * [0.2, 0.3, 0.5, 0.15, 0.5, 1.0], jnp.float32)
        a = rng.normal(size=(6, 6)) * rng.uniform(0.02, 0.3)
        p0 = jnp.asarray(a @ a.T + 1e-3 * np.eye(6), jnp.float32)
        for m in ("eigh", "jacobi"):
            pr, _ = ukf_init(x0, p0, jnp.zeros((6, 6), jnp.float32),
                             jnp.eye(5, dtype=jnp.float32), sqrt_method=m)
            sig = sigma_points(pr, x0, p0)
            mean, cov = unscented_transform(pr.wm, pr.wc, sig,
                                            jnp.zeros((6, 6), jnp.float32))
            # mean atol = the f32 floor: wm[1]≈1.7e5 amplifies the rounding
            # already committed in forming x±L (eigh itself sits at ~1.5e-4)
            np.testing.assert_allclose(np.array(mean), np.array(x0),
                                       atol=5e-4, err_msg=f"trial {trial} {m} mean")
            pscale = max(np.abs(np.array(p0)).max(), 1e-3)
            np.testing.assert_allclose(np.array(cov) / pscale,
                                       np.array(p0) / pscale, atol=2e-3,
                                       err_msg=f"trial {trial} {m} cov")


def test_ukf_jacobi_matches_eigh_on_linear_model():
    """Under LINEAR fx/hx the UT depends only on the first two moments of
    the sigma set — which every valid root reproduces (moment contract
    above) — so eigh and jacobi must produce the same posterior up to the
    decomposition residual, with no chaotic amplification to excuse. This
    pins filter-level equivalence of the Jacobi root on a well-posed
    problem (cf. two-liner-kf.rs: linear KF is the reference's own oracle
    tier). Run in f64 so the assertion sits at the decomposition residual
    (~1e-6) instead of the f32 UT roundoff floor (~2e-3, measured)."""
    rng = np.random.default_rng(11)
    with jax.enable_x64(True):
        a_lin = jnp.asarray(np.eye(6) + 0.05 * rng.normal(size=(6, 6)))
        h_lin = jnp.asarray(rng.normal(size=(5, 6)))

        def fx(xv, u):
            return xv @ a_lin.T + 0.1 * u

        def hx(xv):
            return xv @ h_lin.T

        q = jnp.diag(jnp.asarray([0, 0, 0, 0, 0, 10.0]))
        r = jnp.diag(jnp.asarray([4.0, 4.0, 0.5, 4.0, 4.0]))
        for trial in range(20):
            x0 = jnp.asarray(rng.normal(size=6) * [0.2, 0.3, 0.5, 0.15, 0.5, 1.0])
            a = rng.normal(size=(6, 6)) * rng.uniform(0.02, 0.3)
            p0 = jnp.asarray(a @ a.T + 1e-3 * np.eye(6))
            z = jnp.asarray(np.array(h_lin) @ np.array(x0) + rng.normal(size=5))
            states = {}
            for m in ("eigh", "jacobi"):
                pr, s = ukf_init(x0, p0, q, r, sqrt_method=m)
                states[m] = ukf_update(
                    pr, ukf_predict(pr, s, jnp.asarray(0.1), fx), z, hx)
            xe, xj = np.array(states["eigh"].x), np.array(states["jacobi"].x)
            scale = np.maximum(np.abs(xe), 1.0)
            np.testing.assert_allclose(xj / scale, xe / scale, atol=1e-5,
                                       err_msg=f"trial {trial}")
            pe_, pj_ = np.array(states["eigh"].p), np.array(states["jacobi"].p)
            pscale = max(np.abs(pe_).max(), 1e-3)
            np.testing.assert_allclose(pj_ / pscale, pe_ / pscale, atol=1e-5,
                                       err_msg=f"trial {trial} P")


def test_jacobi_jit_vmap_reconstructs():
    """Regression: the masked-whole-matrix Jacobi update form miscompiled
    under jit(vmap(...)) on CPU XLA — two near-degenerate eigenvalues
    collapsed toward their mean (reconstruction error ~5e-2 while the
    unjitted and unvmapped paths were exact to 3e-15). The entry-list form
    (smallalg.jacobi_entries) must reconstruct under jit+vmap exactly."""
    import numpy as np

    from mpc_rs_jax.estimators.smallalg import eigh_jacobi_unrolled

    rng = np.random.default_rng(7)
    b, n = 32, 4
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    p0 = (0.05 * (a @ a.transpose(0, 2, 1)) + 0.1 * np.eye(n, dtype=np.float32)).astype(
        np.float64
    )
    p0[0] = 0.3 * np.eye(n)  # exactly degenerate
    w, v = jax.jit(jax.vmap(eigh_jacobi_unrolled))(jnp.asarray(p0))
    rec = np.einsum("bik,bk,bjk->bij", np.array(v), np.array(w), np.array(v))
    assert np.abs(rec - p0).max() < 1e-10
    orth = np.einsum("bik,bjk->bij", np.array(v), np.array(v)) - np.eye(n)
    assert np.abs(orth).max() < 1e-10


def test_ukf_observation_normalization_equivalence_f64():
    """Observation-channel normalization (apps/fleet.py flagship6,
    ``obs_normalize``) is a pure diagonal change of observation
    coordinates: z' = z/s, hx' = hx/s, R' = R/s² give the IDENTICAL
    posterior (x, P) in exact arithmetic. Pinned here in f64 on the
    flagship hx/R so the f32 fleet default's claim of math-identity rests
    on a test, not on algebra in a comment."""
    p = CartPoleParams.two_wheel()
    dt = 0.01
    hx = observation.make_hx_imu6(p)
    s = jnp.asarray([200.0, 200.0, 10.0, 0.05, 0.05], jnp.float64)
    from mpc_rs_jax.models import noise as noise_mod

    q = noise_mod.gen_q6(jnp.float64(2.15 * dt))
    r_raw = jnp.diag(s)  # the reference's σ-as-R quirk, verbatim
    fx6 = dynamics.make_flagship6(p)

    def fxd(xv, uu):
        out = fx6(*(xv[..., i] for i in range(6)), uu, jnp.float64(dt),
                  jnp.float64(0.0))
        return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

    rng = np.random.default_rng(11)
    x0 = jnp.asarray(0.05 * rng.standard_normal(6))
    p0 = 0.1 * jnp.eye(6, dtype=jnp.float64)
    pr, er = ukf_init(x0, p0, q, r_raw)
    pn, en = ukf_init(x0, p0, q, jnp.diag(jnp.asarray(1.0) / s))
    hx_n = lambda x: hx(x) / s
    for step in range(10):
        u = float(rng.uniform(-5, 5))
        z = np.asarray(hx(er.x)) + np.asarray(s) * rng.standard_normal(5)
        er = ukf_predict(pr, er, u, fxd)
        er = ukf_update(pr, er, jnp.asarray(z), hx)
        en = ukf_predict(pn, en, u, fxd)
        en = ukf_update(pn, en, jnp.asarray(z) / s, hx_n)
        np.testing.assert_allclose(np.asarray(en.x), np.asarray(er.x),
                                   rtol=1e-6, atol=1e-6)
        # P tolerance leaves room for the RAW path's own f64 rounding: its
        # innovation covariance spans ~8 decades, so the two algebraically
        # identical computations round differently at the ~5e-7-relative
        # level on the smallest P entries — the conditioning gap the
        # normalization removes. (Note: the round-5 bisection showed the
        # flagship's measured 25% f32 θ-RMS inflation came from the α=1e-3
        # UT weight amplification in PREDICT, not from this update-side
        # conditioning — see test_f32_predict_alpha_conditioning below;
        # normalization remains a valid identity, pinned here.)
        np.testing.assert_allclose(np.asarray(en.p), np.asarray(er.p),
                                   rtol=1e-5, atol=1e-8)


def test_f32_predict_alpha_conditioning():
    """The f32 production spread is α=1 (apps/fleet.py fleet_alpha), NOT
    the reference's Merwe α=1e-3 (src/ukf.rs:23-28): with α=1e-3 the UT
    weights are 1/(2α²(n+κ)) ≈ 1.7e5, which multiplies the ~ulp rounding
    of every propagated sigma point straight into the predicted mean.
    This pins both halves of the round-5 finding (DESIGN §18):

      (a) at α=1, one f32 predict matches the f64 predict tightly;
      (b) at α=1e-3, the f32 deviation is ≥1e3× LARGER than at α=1 —
          the amplification that inflated the est-in-loop flagship's
          free-running θ-RMS 0.135 → 0.17-0.18 until round 5
          (scripts/diag_flagship_est_bisect.py; closed-loop distribution
          checked against the oracle by scripts/parity_dist.py).
    """
    from mpc_rs_jax.models import noise as noise_mod

    p = CartPoleParams.two_wheel()
    dt = 0.01
    fx6 = dynamics.make_flagship6(p)

    def fxd(dtype):
        def f(xv, uu):
            out = fx6(*(xv[..., i] for i in range(6)), uu,
                      jnp.asarray(dt, dtype), jnp.asarray(0.0, dtype))
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)
        return f

    q = noise_mod.gen_q6(jnp.float64(2.15 * dt))
    rng = np.random.default_rng(3)
    x0 = np.array([0.3, 0.5, 2.0, 0.08, 0.4, 1.0])
    a = rng.normal(size=(6, 6))
    p0 = 1e-4 * (a @ a.T) + np.diag([1e-4, 1e-3, 1e-2, 1e-5, 1e-4, 1e-3])
    r = np.diag([200.0, 200.0, 10.0, 0.05, 0.05])
    u = 1.7

    err = {}
    for alpha in (1e-3, 1.0):
        pr64, st64 = ukf_init(jnp.asarray(x0), jnp.asarray(p0), q,
                              jnp.asarray(r), alpha=alpha)
        pr32, st32 = ukf_init(jnp.asarray(x0, jnp.float32),
                              jnp.asarray(p0, jnp.float32),
                              q.astype(jnp.float32),
                              jnp.asarray(r, jnp.float32), alpha=alpha)
        e64 = ukf_predict(pr64, st64, jnp.float64(u), fxd(jnp.float64))
        e32 = ukf_predict(pr32, st32, jnp.float32(u), fxd(jnp.float32))
        err[alpha] = float(np.max(np.abs(
            np.asarray(e64.x, np.float64) - np.asarray(e32.x, np.float64))))
    assert err[1.0] < 1e-4, err  # (a): α=1 f32 predict is f64-faithful
    assert err[1e-3] > 1e3 * err[1.0], err  # (b): α=1e-3 amplifies ≥1e3×


def test_f32_closed_loop_estimator_fidelity():
    """Closed-loop-scale companion to the single-predict α test above:
    a 300-tick flagship trajectory (f64 plant, stabilizing state feedback,
    noisy IMU observations) is replayed tick-for-tick through four
    filters on IDENTICAL (u, z) sequences. Two claims pinned at this
    scale:

    (a) the fleet-default f32 α=1 filter tracks the f64 filter's
        est-vs-truth accuracy on every controller channel;
    (b) on matched inputs, the f32 α=1e-3 filter's STATE walks away from
        its own f64 twin orders of magnitude faster than the α=1 pair —
        the per-tick predicted-mean noise the Merwe weights amplify.

    Note the open-loop replay deliberately does NOT reproduce the 1.38 m
    est-vs-truth blowup of the free-running bisect (DESIGN §18): with a
    truth-fed trajectory the measurement updates keep even the noisy
    filter anchored; the meter-scale error is a CLOSED-LOOP effect (the
    controller regulates the noisy estimate to zero while the truth
    drifts), measured where it occurs — in the free-running artifact.
    Here we pin the noise injection itself, deterministically."""
    from mpc_rs_jax.models import noise as noise_mod

    p = CartPoleParams.two_wheel()
    dt = 0.01
    plant6 = dynamics.make_flagship6(p)
    hx = observation.make_hx_imu6(p)
    sens = np.array([200.0, 200.0, 10.0, 0.05, 0.05])
    q64 = noise_mod.gen_q6(jnp.float64(2.15 * dt))
    rng = np.random.default_rng(42)

    # f64 truth trajectory under simple stabilizing feedback on x4
    gains = np.array([2.0, 3.0, 30.0, 6.0])  # x, dx, th, dth
    x = np.zeros(6)
    us, zs, truth = [], [], []
    for i in range(300):
        u = float(np.clip(-gains @ x[[0, 1, 3, 4]], -10.0, 10.0))
        x = np.array([float(v) for v in plant6(
            *(jnp.float64(c) for c in x), jnp.float64(u), jnp.float64(dt),
            jnp.float64(0.0))])
        assert abs(x[3]) < np.pi / 2
        z = np.asarray(hx(jnp.asarray(x)), np.float64) \
            + sens * rng.standard_normal(5)
        us.append(u)
        zs.append(z)
        truth.append(x.copy())
    truth = np.asarray(truth)

    def replay(dtype, alpha):
        def fxd(xv, uu):
            out = plant6(*(xv[..., i] for i in range(6)), uu,
                         jnp.asarray(dt, dtype), jnp.asarray(0.0, dtype))
            return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

        params, est = ukf_init(jnp.zeros(6, dtype),
                               jnp.asarray(0.1 * np.eye(6), dtype),
                               q64.astype(dtype),
                               jnp.asarray(np.diag(sens), dtype),
                               alpha=alpha)

        @jax.jit
        def tick(state, u, z):
            state = ukf_predict(params, state, u, fxd)
            return ukf_update(params, state, z, hx)

        xs = []
        for i in range(300):
            est = tick(est, jnp.asarray(us[i], dtype),
                       jnp.asarray(zs[i], dtype))
            xs.append(np.asarray(est.x, np.float64))
        return np.asarray(xs)  # (300, 6) estimate trajectory

    t64_j = replay(jnp.float64, 1.0)
    t32_j = replay(jnp.float32, 1.0)
    t64_m = replay(jnp.float64, 1e-3)
    t32_m = replay(jnp.float32, 1e-3)

    sl = np.array([0, 1, 3, 4])  # controller channels

    def settled_rms(traj):
        e = traj[100:, sl] - truth[100:][:, sl]
        return np.sqrt(np.mean(e ** 2, axis=0))

    # (a) fleet default: f32 α=1 tracks f64 est-vs-truth accuracy
    np.testing.assert_array_less(settled_rms(t32_j),
                                 1.3 * settled_rms(t64_j) + 1e-4)

    # (b) matched-input f32-vs-f64 twin divergence: the Merwe pair walks
    # away much faster than the Julier pair (measured ~48× on this
    # trajectory: 0.35 vs 0.0073 — the filter recursion amplifies even
    # benign rounding over 300 steps, so the Julier floor is not ulp-tiny,
    # but the Merwe spread adds ~1.7e5-weighted noise each predict)
    dev_j = np.sqrt(np.mean((t32_j - t64_j)[100:] ** 2, axis=0)).max()
    dev_m = np.sqrt(np.mean((t32_m - t64_m)[100:] ** 2, axis=0)).max()
    assert dev_m > 20.0 * dev_j, (dev_m, dev_j)
