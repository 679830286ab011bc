"""K-sharded MPPI: the rayon pool (src/mppi.rs:39-84) re-designed as
``shard_map`` over a ``rollouts`` mesh axis with one collective round.

Each device computes softmax partials (m, s, uw) for its K/n_dev rollouts —
through the fused kernel (ops/mppi_pallas.py) or the vmap reference path —
then a single log-sum-exp merge combines the devices:

    m* = pmax(m);  s* = psum(s · e^((m−m*)/λ));  uw* = psum(uw · e^((m−m*)/λ))

exactly the carried-max scheme SURVEY §5 calls for ("cross-host softmax
normalization without a second pass").
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from mpc_rs_jax.controllers.mppi import (
    NEG_BIG,
    MppiConfig,
    MppiPartials,
    finalize_partials,
    rollout_scores,
)
from mpc_rs_jax.ops.mppi_pallas import mppi_partials


def _jnp_partials(cfg: MppiConfig, dynamics, cost, key, x, u_n, k_local: int,
                  eps=None, unroll=False) -> MppiPartials:
    """Reference-path partials (vmap+scan) for CPU meshes / parity tests.
    ``eps``: optional externally supplied (k_local, N) perturbations
    (already scaled) — the matched-noise seam for oracle cross-validation
    of the sharded tier (see controllers.mppi.mppi_solve ``noise``)."""
    if eps is None:
        eps = cfg.std_dev * jax.random.normal(key, (k_local, cfg.n_horizon), dtype=u_n.dtype)
    v = jnp.clip(u_n + eps, cfg.limit[0], cfg.limit[1])
    s_k = rollout_scores(dynamics, cost, tuple(x), v, u_n, cfg.std_dev, cfg.control_inv, unroll)
    finite = jnp.isfinite(s_k)
    m = jnp.max(jnp.where(finite, s_k, jnp.asarray(NEG_BIG, u_n.dtype)))
    e = jnp.where(finite, jnp.exp((s_k - m) / cfg.lambda_), 0.0)
    return MppiPartials(m=m, s=jnp.sum(e), uw=e @ v)


def merge_devices(parts: MppiPartials, lambda_: float, axis: str) -> MppiPartials:
    """One pmax/psum log-sum-exp round over ``axis``. m and s may carry a
    leading batch shape; uw has one more trailing (N,) axis."""
    m_g = jax.lax.pmax(parts.m, axis)
    scale = jnp.exp((parts.m - m_g) / lambda_)
    return MppiPartials(
        m=m_g,
        s=jax.lax.psum(parts.s * scale, axis),
        uw=jax.lax.psum(parts.uw * scale[..., None], axis),
    )


def make_sharded_mppi(
    cfg: MppiConfig,
    dynamics: Callable,
    cost: Callable,
    n_state: int,
    mesh: Mesh,
    *,
    axis: str = "rollouts",
    backend: str = "pallas",
    block: int | None = None,
    interpret: bool = False,
    external_noise: bool = False,
):
    """Returns jitted ``solve(seed_or_key, x, u_n) -> (u_n', status)``.

    K = cfg.n_rollouts is split evenly over ``mesh[axis]``.

    ``backend="pallas"``: the first argument is an int seed. Device d
    draws the kernel's counter-based noise for global rollouts
    d·K/n_dev … (d+1)·K/n_dev − 1, so the merged solve sees exactly the
    samples a one-device solve with the same seed sees.

    ``backend="jnp"``: the first argument is a PRNG key, folded with the
    device index (independent streams per device, the principled version
    of the reference's per-thread from_entropy, src/mppi.rs:41).

    ``external_noise``: the first argument is instead the (K, N) noise
    matrix (already scaled by σ), sharded over the axis — the
    matched-noise seam of ``mppi_solve(noise=...)``, for either backend.
    """
    n_dev = mesh.shape[axis]
    if cfg.n_rollouts % n_dev:
        raise ValueError(f"K={cfg.n_rollouts} not divisible by {n_dev} devices")
    k_local = cfg.n_rollouts // n_dev
    if backend not in ("pallas", "jnp"):
        raise ValueError(backend)

    def local_partials(first, x, u_n):
        if backend == "jnp":
            key = None if external_noise else jax.random.fold_in(first, jax.lax.axis_index(axis))
            return _jnp_partials(cfg, dynamics, cost, key, x, u_n, k_local,
                                 eps=first if external_noise else None)
        kw = dict(n_rollouts=k_local, block=block, interpret=interpret)
        if external_noise:
            return mppi_partials(cfg, dynamics, cost, n_state, 0, x, u_n, noise=first, **kw)
        return mppi_partials(cfg, dynamics, cost, n_state, first[0], x, u_n,
                             offset=jax.lax.axis_index(axis) * k_local, **kw)

    sharded = shard_map(
        lambda first, x, u_n: merge_devices(local_partials(first, x, u_n), cfg.lambda_, axis),
        mesh=mesh,
        in_specs=(P(axis, None) if external_noise else P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )

    @jax.jit
    def solve(seed_or_key, x, u_n):
        if backend == "pallas" and not external_noise:
            seed_or_key = jnp.asarray(seed_or_key, jnp.int32).reshape(1)
        parts = sharded(seed_or_key, x, u_n)
        # partials are replicated after the collectives; take them as-is
        return finalize_partials(cfg, parts, u_n)

    return solve
