"""Unrolled small-matrix algebra vs numpy.linalg."""

import jax.numpy as jnp
import numpy as np

from mpc_rs_jax.estimators.smallalg import chol_solve_unrolled, chol_unrolled, spd_solve_unrolled


def _spd(rng, b, n):
    a = rng.normal(size=(b, n, n))
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


def test_chol_unrolled_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (2, 3, 4, 5, 6):
        s = _spd(rng, 7, n)
        l = np.array(chol_unrolled(jnp.asarray(s)))
        want = np.linalg.cholesky(s)
        np.testing.assert_allclose(l, want, rtol=1e-10, atol=1e-12)


def test_chol_solve_matches_numpy():
    rng = np.random.default_rng(1)
    for n in (3, 4, 6):
        s = _spd(rng, 5, n)
        b = rng.normal(size=(5, n, 2))
        x = np.array(chol_solve_unrolled(chol_unrolled(jnp.asarray(s)), jnp.asarray(b)))
        want = np.linalg.solve(s, b)
        np.testing.assert_allclose(x, want, rtol=1e-8, atol=1e-10)


def test_spd_solve_near_singular_with_jitter():
    n = 4
    s = np.diag([1.0, 1.0, 1.0, 1e-14])  # near-PSD
    b = np.ones((n, 1))
    x = np.array(spd_solve_unrolled(jnp.asarray(s), jnp.asarray(b), jitter_rel=1e-9))
    assert np.isfinite(x).all()


def test_chol_unrolled_near_psd_zeroes_column():
    """A ~zero pivot must zero its column (graceful PSD semantics), not
    explode to 1/sqrt(eps) — regression for the fleet-divergence bug."""
    s = np.diag([1.0, -1e-9, 1.0, 1.0])  # slightly indefinite
    s[1, 2] = s[2, 1] = 0.3
    l = np.array(chol_unrolled(jnp.asarray(s, jnp.float32)))
    assert np.isfinite(l).all()
    assert np.abs(l).max() < 10.0, f"exploding factor: {l}"
    assert l[1, 1] == 0.0 and l[2, 1] == 0.0  # zeroed column


def test_eigh_jacobi_unrolled_accuracy():
    """Batched unrolled Jacobi: reconstruction, eigenvalue, and
    orthogonality error bounds on random SPD matrices (n=4, 6)."""
    import numpy as np
    import jax.numpy as jnp

    from mpc_rs_jax.estimators.smallalg import eigh_jacobi_unrolled

    rng = np.random.default_rng(3)
    for n in (4, 6):
        m = rng.normal(size=(64, n, n)).astype(np.float32)
        s = (m @ np.swapaxes(m, -1, -2)) + 0.01 * np.eye(n, dtype=np.float32)
        w, v = eigh_jacobi_unrolled(jnp.asarray(s))
        w, v = np.asarray(w), np.asarray(v)
        rec = v @ (w[..., None] * np.swapaxes(v, -1, -2))
        assert np.abs(rec - s).max() / np.abs(s).max() < 5e-4
        wr = np.linalg.eigvalsh(s)
        assert np.abs(np.sort(w, axis=-1) - wr).max() / np.abs(wr).max() < 1e-5
        assert np.abs(v @ np.swapaxes(v, -1, -2) - np.eye(n)).max() < 1e-5
