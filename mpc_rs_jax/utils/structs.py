"""Small structural helpers shared across the engine.

The dynamics/cost/observation zoo (mpc_rs_jax.models) is written in
"structure-of-arrays" style: every model function takes the state as
*unpacked per-component arrays* (``step(x0, x1, ..., u) -> tuple``) so the
same trace works

- under ``vmap`` over K rollouts (components of shape ``(K,)``),
- inside Pallas kernels (components of shape ``(block,)``, one rollout per thread),
- and on plain scalars for single-step simulation.

The estimators (UKF/KF) want vector-valued callables ``f(x, u) -> x`` with
``x.shape == (..., n)``; ``as_vector_fn`` adapts between the two.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax.numpy as jnp


def clamp(x, lo, hi):
    """Saturating clamp, the JAX analogue of Rust's ``f64::clamp``."""
    return jnp.clip(x, lo, hi)


def as_vector_fn(step: Callable, n: int) -> Callable:
    """Adapt a component-wise ``step(*xs, u)`` into ``f(x, u)`` on ``(..., n)``.

    Broadcasting over leading axes is preserved, so the returned function is
    directly usable for sigma-point propagation (x of shape ``(m, n)``) and
    batched scenarios without an extra ``vmap``.
    """

    def f(x, u):
        out = step(*(x[..., i] for i in range(n)), u)
        return jnp.stack(jnp.broadcast_arrays(*out), axis=-1)

    return f


def stack_components(xs: Sequence, axis: int = -1):
    return jnp.stack(jnp.broadcast_arrays(*xs), axis=axis)
