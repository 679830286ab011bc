"""Fused kernels and the one place that decides whether they can run."""

from __future__ import annotations

import jax


def kernel_available(device=None) -> bool:
    """Whether the fused Triton kernels compile for ``device`` (default:
    the device JAX places arrays on) — true on an NVIDIA GPU."""
    device = device or jax.devices()[0]
    return device.platform == "gpu"


def resolve_backend(requested: str | None = None, *, interpret: bool = False) -> str:
    """The MPPI path to use: ``"pallas"`` (the fused kernel) or ``"vmap"``
    (the plain jax.numpy path).

    ``None`` takes the kernel where it can run and the plain path
    elsewhere. An explicit ``"pallas"`` needs a GPU unless the caller asks
    for ``interpret=True`` (the Pallas interpreter, for tests and CPU dry
    runs); it never falls back silently.
    """
    if requested not in (None, "pallas", "vmap"):
        raise ValueError(f"unknown MPPI backend {requested!r}")
    if requested is None:
        return "pallas" if kernel_available() else "vmap"
    if requested == "pallas" and not interpret and not kernel_available():
        raise RuntimeError(
            "backend='pallas' needs an NVIDIA GPU; on "
            f"{jax.devices()[0].platform!r} pass interpret=True or use backend='vmap'"
        )
    return requested


__all__ = ["kernel_available", "resolve_backend"]
