"""Fused MPPI kernel (Pallas on Triton, interpreted on CPU) + sharded solve.

The kernel's counter-based generator has a plain-jnp twin
(counter_normals), so every value test here is exact matched-noise parity
against the reference path. The compiled kernel runs on a GPU in
chip_smoke.py and in the ``gpu``-marked tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_rs_jax.controllers.mppi import MppiConfig, MppiStatus, mppi_solve, rollout_scores
from mpc_rs_jax.models import costs, dynamics
from mpc_rs_jax.models.params import CartPoleParams
from mpc_rs_jax.ops import mppi_pallas as mp
from mpc_rs_jax.ops.mppi_pallas import (
    counter_normals,
    mppi_solve_pallas,
    mppi_solve_pallas_batch,
)
from mpc_rs_jax.parallel import make_mesh, make_sharded_mppi

P = CartPoleParams.single_wheel()
N = 8


def _cfg(k, lam=0.5, n=N, sd=3.0, lim=20.0):
    return MppiConfig(n_horizon=n, n_rollouts=k, lambda_=lam, std_dev=sd, limit=(-lim, lim))


def _ref_solve(cfg, step, cost, x, u_n, eps):
    """Ground-truth softmax/weighted average on the same samples (f64)."""
    v = np.clip(np.asarray(u_n, np.float64) + np.asarray(eps, np.float64), *cfg.limit)
    s = np.array(rollout_scores(step, cost, tuple(jnp.float64(c) for c in np.asarray(x)),
                                jnp.asarray(v), jnp.asarray(u_n, jnp.float64), cfg.std_dev,
                                cfg.control_inv))
    w = np.exp((s - s.max()) / cfg.lambda_)
    return (w / w.sum()) @ v


def test_kernel_exact_parity_same_noise():
    step = dynamics.make_cartpole_nonlinear(P, 0.1)
    cfg = _cfg(2048)
    eps = 3.0 * jax.random.normal(jax.random.key(0), (2048, N), dtype=jnp.float32)
    x = jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32)
    u_n = jnp.zeros(N, jnp.float32)
    u_pal, st = mppi_solve_pallas(cfg, step, costs.shaped4, 4, 0, x, u_n, interpret=True, noise=eps)
    assert int(st) == MppiStatus.OK
    np.testing.assert_allclose(np.array(u_pal), _ref_solve(cfg, step, costs.shaped4, x, u_n, eps),
                               rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("block", [32, 64, 256])
def test_kernel_streaming_logsumexp_multi_block_invariance(block):
    """Partials must not depend on the block partition: the same samples
    in 32..256-rollout blocks give the u of one 1024-rollout block."""
    step = dynamics.make_double_integrator(0.05)
    cfg = _cfg(1024, lam=2.5)
    eps = 3.0 * jax.random.normal(jax.random.key(1), (1024, N), dtype=jnp.float32)
    x = jnp.asarray([1.0, 0.0], jnp.float32)
    u_n = jnp.full((N,), 0.3, jnp.float32)
    solve = lambda bk: mppi_solve_pallas(cfg, step, costs.quad2, 2, 0, x, u_n, block=bk,
                                         interpret=True, noise=eps)
    np.testing.assert_allclose(np.array(solve(block)[0]), np.array(solve(1024)[0]),
                               rtol=2e-4, atol=1e-5)


def test_kernel_warm_start_and_clamp():
    step = dynamics.make_double_integrator(0.05)
    cfg = _cfg(1024)
    # huge nominal → samples clamp at the limit → u' must respect limits
    x = jnp.asarray([1.0, 0.0], jnp.float32)
    u_n = jnp.full((N,), 100.0, jnp.float32)
    u, st = mppi_solve_pallas(cfg, step, costs.quad2, 2, 3, x, u_n, interpret=True)
    assert int(st) == MppiStatus.OK
    np.testing.assert_allclose(np.array(u), cfg.limit[1], atol=1e-4)  # all samples clamp to hi


def test_kernel_no_finite_status():
    step = dynamics.make_double_integrator(0.05)
    bad_cost = lambda a, b: jnp.full_like(a, jnp.inf)
    u, st = mppi_solve_pallas(_cfg(1024), step, bad_cost, 2, 0, jnp.asarray([1.0, 0.0], jnp.float32),
                              jnp.zeros(N, jnp.float32), interpret=True)
    assert int(st) == MppiStatus.NO_FINITE
    np.testing.assert_array_equal(np.array(u), 0.0)


def test_sharded_jnp_backend_matches_unsharded_partials():
    """8-device rollout-sharded solve must equal a single-device solve that
    uses the same per-shard keys (the collective log-sum-exp is exact)."""
    step = dynamics.make_cartpole_nonlinear(P, 0.1)
    mesh = make_mesh()
    n_dev = mesh.shape["rollouts"]
    k_local = 512
    cfg = _cfg(n_dev * k_local)
    solve = make_sharded_mppi(cfg, step, costs.shaped4, 4, mesh, backend="jnp")
    x = jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32)
    u_n = jnp.zeros(N, jnp.float32)
    key = jax.random.key(0)
    u_sh, st = solve(key, x, u_n)
    assert int(st) == MppiStatus.OK

    eps = np.concatenate([
        3.0 * np.array(jax.random.normal(jax.random.fold_in(key, d), (k_local, N), dtype=jnp.float32))
        for d in range(n_dev)])
    np.testing.assert_allclose(np.array(u_sh), _ref_solve(cfg, step, costs.shaped4, x, u_n, eps),
                               rtol=1e-3, atol=5e-4)


def test_sharded_pallas_interpret_on_cpu_mesh():
    """The kernel under shard_map on 8 CPU devices: each device draws its
    own slice of the counter space, so the merged solve equals one
    device's solve with the same seed, and the plain reference on the
    same samples."""
    step = dynamics.make_cartpole_nonlinear(P, 0.1)
    mesh = make_mesh()
    cfg = _cfg(mesh.shape["rollouts"] * 256)
    x = jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32)
    u_n = jnp.zeros(N, jnp.float32)
    solve = make_sharded_mppi(cfg, step, costs.shaped4, 4, mesh, backend="pallas", interpret=True)
    u, st = solve(3, x, u_n)
    assert int(st) == MppiStatus.OK
    u1, _ = mppi_solve_pallas(cfg, step, costs.shaped4, 4, 3, x, u_n, interpret=True)
    np.testing.assert_allclose(np.array(u), np.array(u1), rtol=1e-4, atol=1e-5)
    eps = cfg.std_dev * counter_normals(3, 0, cfg.n_rollouts, N)
    np.testing.assert_allclose(np.array(u), _ref_solve(cfg, step, costs.shaped4, x, u_n, eps),
                               rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_sharded_external_noise_matches_single_solve(backend):
    """Both backends' external-noise seam: (K, N) rows sharded over 8
    devices reproduce mppi_solve on the same rows."""
    step = dynamics.make_cartpole_nonlinear(P, 0.1)
    mesh = make_mesh()
    cfg = _cfg(mesh.shape["rollouts"] * 256)
    x = jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32)
    u_n = jnp.zeros(N, jnp.float32)
    eps = 3.0 * jax.random.normal(jax.random.key(4), (cfg.n_rollouts, N), dtype=jnp.float32)
    solve = make_sharded_mppi(cfg, step, costs.shaped4, 4, mesh, backend=backend,
                              interpret=True, external_noise=True)
    u, st = solve(eps, x, u_n)
    ref = mppi_solve(cfg, step, costs.shaped4, None, tuple(x), u_n, noise=eps)
    assert int(st) == int(ref.status) == MppiStatus.OK
    np.testing.assert_allclose(np.array(u), np.array(ref.u_n), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("seed,stream,n", [
    (5, 0, 8), (6, 0, 8), (7, 1, 8), (5, 0, 20), (123, 3, 3), (2**31 - 1, 7, 2),
])
def test_kernel_prng_statistics(seed, stream, n):
    """The in-kernel generator is mean-zero and equals its plain twin:
    huge λ ⇒ uniform weights ⇒ u' = mean(v) over K=4096 draws, which is
    both ≈ u_n (K^-1/2 sampling floor) and the twin's exact mean."""
    step = dynamics.make_double_integrator(0.05)
    cfg = _cfg(4096, lam=1e9, n=n, sd=1.0, lim=50.0)
    u, st = mppi_solve_pallas(cfg, step, lambda a, b: 0.0 * a, 2, seed,
                              jnp.zeros(2, jnp.float32), jnp.zeros(n, jnp.float32),
                              stream=stream, interpret=True)
    assert int(st) == MppiStatus.OK
    twin_mean = np.asarray(counter_normals(seed, stream, 4096, n), np.float64).mean(axis=0)
    np.testing.assert_allclose(np.array(u), twin_mean, atol=1e-5)
    np.testing.assert_allclose(np.array(u), 0.0, atol=5.0 / np.sqrt(4096))


def test_counter_normals_bit_identical_to_jax_threefry():
    """threefry2x32 is JAX's own threefry-2x32, word for word."""
    from jax._src import prng

    key = jnp.array([123, 7], jnp.uint32)
    c0 = jnp.arange(64, dtype=jnp.uint32)
    c1 = jnp.full_like(c0, 3)
    words = mp.threefry2x32(key[0], key[1], c0, c1)
    np.testing.assert_array_equal(np.concatenate([np.array(words[0]), np.array(words[1])]),
                                  np.array(prng.threefry_2x32(key, jnp.concatenate([c0, c1]))))


def test_counter_normals_distribution():
    """2^20 draws: moments and KS distance to N(0,1) at the bounds the GPU
    phase of chip_smoke.py applies to the compiled generator."""
    from scipy.special import ndtr

    z = np.sort(np.asarray(counter_normals(99, 1, 1 << 17, 8), np.float64).ravel())
    n = z.size
    assert abs(z.mean()) < 5 / np.sqrt(n)
    assert abs(z.var() - 1.0) < 5 * np.sqrt(2 / n)
    cdf = ndtr(z)
    ks = max(np.max(np.arange(1, n + 1) / n - cdf), np.max(cdf - np.arange(n) / n))
    assert ks < 1.95 / np.sqrt(n)


def test_counter_normals_offset_is_a_slice():
    """offset shifts the counter: rollouts offset..offset+k-1 of one stream
    — what lets a K-sharded solve draw one device's samples on many."""
    full = counter_normals(8, 2, 1024, 5)
    np.testing.assert_array_equal(np.array(counter_normals(8, 2, 256, 5, offset=512)),
                                  np.array(full[512:768]))


def test_kernel_normals_match_twin_interpret():
    np.testing.assert_array_equal(np.array(mp.kernel_normals(3, 1, 512, 5, interpret=True)),
                                  np.array(counter_normals(3, 1, 512, 5)))


def test_batched_kernel_matches_per_scenario_reference():
    """Scenario-batched launch: scenario b draws from key (seeds[b], 0) and
    must equal its own single solve on those samples."""
    step = dynamics.make_double_integrator(0.05)
    b, k = 16, 1024
    cfg = MppiConfig(n_horizon=8, n_rollouts=k, lambda_=2.5, std_dev=1.0, limit=(-3.0, 3.0))
    u_ns = jnp.tile(jnp.linspace(-5.0, 5.0, 8, dtype=jnp.float32), (b, 1))
    u_ns = u_ns * (jnp.arange(b, dtype=jnp.float32)[:, None] + 1) / b
    xs = jnp.stack([jnp.linspace(-1, 1, b, dtype=jnp.float32), jnp.zeros(b, jnp.float32)], axis=-1)
    seeds = jnp.arange(b, dtype=jnp.int32) * 31
    u, st = mppi_solve_pallas_batch(cfg, step, costs.quad2, 2, seeds, xs, u_ns, interpret=True)
    assert u.shape == (b, 8) and st.shape == (b,)
    assert (np.array(st) == 0).all()
    for i in range(b):
        eps = cfg.std_dev * counter_normals(seeds[i], 0, k, 8)
        np.testing.assert_allclose(np.array(u[i]), _ref_solve(cfg, step, costs.quad2, xs[i], u_ns[i], eps),
                                   rtol=1e-3, atol=5e-4)


@pytest.mark.parametrize("k_exact", [1024 + 300, 1024 - 300, 129])
def test_kernel_exact_k_masking(k_exact):
    """Non-block-multiple K must use exactly K rollouts: the generator
    keeps drawing past K inside the last block, and those rollouts must
    not leak into the softmax."""
    step = dynamics.make_double_integrator(0.05)
    cfg = MppiConfig(n_horizon=N, n_rollouts=k_exact, lambda_=2.5, std_dev=1.0, limit=(-3.0, 3.0))
    x = jnp.asarray([1.0, 0.0], jnp.float32)
    u_n = jnp.zeros(N, jnp.float32)
    u_pal, st = mppi_solve_pallas(cfg, step, costs.quad2, 2, 9, x, u_n, block=128, interpret=True)
    assert int(st) == MppiStatus.OK
    eps = counter_normals(9, 0, k_exact, N)
    np.testing.assert_allclose(np.array(u_pal), _ref_solve(cfg, step, costs.quad2, x, u_n, eps),
                               rtol=5e-4, atol=5e-4)


def test_batched_kernel_exact_parity_same_noise():
    """Batched kernel vs reference on identical per-scenario (B, K, N)
    noise — the external-noise seam with a partially used last block."""
    step = dynamics.make_double_integrator(0.05)
    b, k_exact = 8, 1024 + 200
    cfg = MppiConfig(n_horizon=N, n_rollouts=k_exact, lambda_=2.5, std_dev=1.0, limit=(-3.0, 3.0))
    eps = np.array(jax.random.normal(jax.random.key(11), (b, k_exact, N), dtype=jnp.float32))
    xs = np.stack([np.linspace(-1, 1, b), np.zeros(b)], axis=-1).astype(np.float32)
    u_ns = np.zeros((b, N), np.float32)
    u, st = mppi_solve_pallas_batch(cfg, step, costs.quad2, 2, jnp.zeros(b, jnp.int32),
                                    jnp.asarray(xs), jnp.asarray(u_ns), interpret=True,
                                    noise=jnp.asarray(eps))
    assert (np.array(st) == 0).all()
    for i in range(b):
        np.testing.assert_allclose(np.array(u[i]), _ref_solve(cfg, step, costs.quad2, xs[i], u_ns[i], eps[i]),
                                   rtol=1e-3, atol=5e-4)


def test_fleet_kernel_exact_parity_same_noise():
    """Fleet shape: K below one block (a single, partially used block per
    scenario), 16 scenarios, vs the reference on identical noise."""
    step = dynamics.make_double_integrator(0.05)
    b, k_exact = 16, 128 - 30
    cfg = MppiConfig(n_horizon=N, n_rollouts=k_exact, lambda_=2.5, std_dev=1.0, limit=(-3.0, 3.0))
    eps = np.array(jax.random.normal(jax.random.key(5), (b, k_exact, N), dtype=jnp.float32))
    xs = np.stack([np.linspace(-1, 1, b), 0.1 * np.ones(b)], axis=-1).astype(np.float32)
    u_ns = np.tile(np.linspace(-0.5, 0.5, N, dtype=np.float32), (b, 1))
    u, st = mppi_solve_pallas_batch(cfg, step, costs.quad2, 2, jnp.zeros(b, jnp.int32),
                                    jnp.asarray(xs), jnp.asarray(u_ns), interpret=True,
                                    block=128, noise=jnp.asarray(eps))
    assert (np.array(st) == 0).all()
    for i in range(b):
        np.testing.assert_allclose(np.array(u[i]), _ref_solve(cfg, step, costs.quad2, xs[i], u_ns[i], eps[i]),
                                   rtol=1e-3, atol=5e-4)


@pytest.mark.parametrize("n", [3, 20, 40])
def test_kernel_horizon_padding(n):
    """Horizons that are not powers of two: the (N,) partial is padded to
    a power of two inside the kernel and trimmed outside."""
    step = dynamics.make_commu4(CartPoleParams.two_wheel(), 1.2 / n)
    cfg = MppiConfig(n_horizon=n, n_rollouts=512, lambda_=2.0, std_dev=2.0, limit=(-10.0, 10.0))
    x = jnp.asarray([0.0, 0.0, 0.1, 0.0], jnp.float32)
    u_n = jnp.linspace(-1.0, 1.0, n, dtype=jnp.float32)
    u, st = mppi_solve_pallas(cfg, step, costs.commu4, 4, 2, x, u_n, interpret=True)
    assert u.shape == (n,) and int(st) == MppiStatus.OK
    ref = mppi_solve(cfg, step, costs.commu4, None, tuple(x), u_n,
                     noise=cfg.std_dev * counter_normals(2, 0, 512, n))
    np.testing.assert_allclose(np.array(u), np.array(ref.u_n), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k,want", [(10_240, 128), (819_200, 128), (100, 128), (33, 64), (1, 1)])
def test_default_block(k, want):
    assert mp.default_block(k) == want
    assert mp._num_warps(want) * 32 == max(32, want)


def test_block_must_be_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        mp.mppi_block_partials(_cfg(300), dynamics.make_double_integrator(0.05), costs.quad2, 2,
                               jnp.zeros(1, jnp.int32), jnp.zeros((1, 2)), jnp.zeros((1, N)),
                               block=96, interpret=True)


def test_noise_shape_is_checked():
    with pytest.raises(ValueError, match="noise must have shape"):
        mp.mppi_block_partials(_cfg(256), dynamics.make_double_integrator(0.05), costs.quad2, 2,
                               jnp.zeros(1, jnp.int32), jnp.zeros((1, 2)), jnp.zeros((1, N)),
                               noise=jnp.zeros((1, 256, N + 1)), interpret=True)


@pytest.mark.parametrize("requested,interpret,want", [
    (None, False, "vmap"), ("vmap", False, "vmap"), ("pallas", True, "pallas"),
])
def test_kernel_choice_on_cpu(requested, interpret, want):
    """One module decides the path: the plain path by default off a GPU,
    the interpreter only when the caller asks for it."""
    from mpc_rs_jax.ops import kernel_available, resolve_backend

    assert not kernel_available()
    assert resolve_backend(requested, interpret=interpret) == want


def test_pallas_without_gpu_raises():
    from mpc_rs_jax.apps.common import make_mppi_solver
    from mpc_rs_jax.ops import resolve_backend

    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        resolve_backend("pallas")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        make_mppi_solver(_cfg(256), dynamics.make_double_integrator(0.05), costs.quad2, 2, "pallas")
    with pytest.raises(ValueError, match="unknown MPPI backend"):
        resolve_backend("xla")


@pytest.mark.parametrize("n,external", [(8, False), (20, False), (20, True)])
def test_kernel_lowers_for_cuda(n, external):
    """The kernel lowers to Triton IR for a CUDA target here, without a
    GPU: every primitive it uses has a Triton lowering and every tensor
    shape is a power of two. (Compiling that IR for the card happens on
    the GPU.)"""
    from jax import export

    cfg = _cfg(100_000, n=n)
    step = dynamics.make_cartpole_nonlinear(P, 0.1, fast=n == 8)
    args = [jax.ShapeDtypeStruct((4,), jnp.float32), jax.ShapeDtypeStruct((n,), jnp.float32)]
    if external:
        f = lambda x, u, e: mppi_solve_pallas(cfg, step, costs.shaped4, 4, 1, x, u, noise=e)
        args.append(jax.ShapeDtypeStruct((100_000, n), jnp.float32))
    else:
        f = lambda x, u: mppi_solve_pallas(cfg, step, costs.shaped4, 4, 1, x, u)
    exp = export.export(jax.jit(f), platforms=["cuda"], disabled_checks=[
        export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")])(*args)
    assert "__gpu$xla.gpu.triton" in exp.mlir_module()


@pytest.mark.gpu
def test_compiled_kernel_matches_reference(gpu):
    """On a GPU: the compiled kernel (approximate PTX transcendentals in
    its generator) against the reference on its own written-out samples."""
    step = dynamics.make_cartpole_nonlinear(P, 0.1)
    cfg = _cfg(819_200)
    x = jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32)
    u_n = jnp.zeros(N, jnp.float32)
    u, st = mppi_solve_pallas(cfg, step, costs.shaped4, 4, 11, x, u_n)
    ref = mppi_solve(cfg, step, costs.shaped4, None, tuple(x), u_n,
                     noise=cfg.std_dev * mp.kernel_normals(11, 0, cfg.n_rollouts, N))
    assert int(st) == int(ref.status) == MppiStatus.OK
    np.testing.assert_allclose(np.array(u), np.array(ref.u_n), atol=1e-3 * cfg.limit[1])
