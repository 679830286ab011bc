"""Checkpoint/resume for controller state pytrees.

The reference has no checkpointing (SURVEY §5); its only carried state is
the warm-started u_n (examples/mppi4.rs:42), the PANOC cache, and UKF
(x, P). Here that whole controller state is a small pytree — saved/restored
to a single .npz (no pickle; array leaves only) for long scaling runs.

For production fleet runs there is also an orbax backend
(``save_pytree(..., backend="orbax")``): atomic directory commits and
native sharded-``jax.Array`` save/restore — a mesh-sharded fleet carry is
written without gathering to host and restored WITH its shardings intact
(npz round-trips through host numpy and loses placement). Typed PRNG keys
are stored as raw key data in both backends.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np


def _is_key(a) -> bool:
    try:
        return jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key)
    except (AttributeError, TypeError):
        return False


def save_pytree(path: str, tree, backend: str = "npz") -> None:
    if backend == "orbax":
        return _save_orbax(path, tree)
    if backend != "npz":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    leaves = jax.tree.leaves(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    for i, l in enumerate(leaves):
        # typed PRNG keys are stored as their raw uint32 key data
        arrays[f"leaf_{i}"] = np.asarray(jax.random.key_data(l) if _is_key(l) else l)
    np.savez(path, **arrays)


def load_pytree(path: str, template, backend: str = "npz"):
    """Restore into the structure of ``template`` (dtypes follow template;
    typed-PRNG-key leaves are re-wrapped from their stored key data)."""
    if backend == "orbax":
        return _load_orbax(path, template)
    if backend != "npz":
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    data = np.load(path)
    leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    t_leaves, treedef = jax.tree.flatten(template)
    if len(leaves) != len(t_leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template expects {len(t_leaves)}"
        )
    cast = []
    for l, t in zip(leaves, t_leaves):
        if _is_key(t):
            cast.append(jax.random.wrap_key_data(jnp.asarray(l)))
        else:
            cast.append(jnp.asarray(l, dtype=getattr(t, "dtype", None)))
    return jax.tree.unflatten(treedef, cast)


def _abstract_leaf(a):
    """Shape/dtype/sharding spec for orbax restore (placement-preserving)."""
    arr = a if hasattr(a, "shape") else jnp.asarray(a)
    sharding = getattr(arr, "sharding", None)
    try:
        return jax.ShapeDtypeStruct(arr.shape, arr.dtype, sharding=sharding)
    except TypeError:  # older jax: no sharding kwarg
        return jax.ShapeDtypeStruct(arr.shape, arr.dtype)


def _orbax():
    """orbax is optional (only ``backend="orbax"`` needs it)."""
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "checkpoint backend 'orbax' needs the orbax-checkpoint package; "
            "use backend='npz' (the default) where it is not installed"
        ) from e
    return ocp


def _save_orbax(path: str, tree) -> None:
    ocp = _orbax()

    flat = {
        f"leaf_{i}": (jax.random.key_data(l) if _is_key(l) else l)
        for i, l in enumerate(jax.tree.leaves(tree))
    }
    ckpt = ocp.StandardCheckpointer()
    try:
        ckpt.save(os.path.abspath(path), flat, force=True)
        ckpt.wait_until_finished()  # async under the hood; commit before returning
    finally:
        ckpt.close()


def _load_orbax(path: str, template):
    ocp = _orbax()

    t_leaves, treedef = jax.tree.flatten(template)
    abstract = {
        f"leaf_{i}": _abstract_leaf(jax.random.key_data(t) if _is_key(t) else t)
        for i, t in enumerate(t_leaves)
    }
    ckpt = ocp.StandardCheckpointer()
    try:
        flat = ckpt.restore(os.path.abspath(path), abstract)
    finally:
        ckpt.close()
    leaves = []
    for i, t in enumerate(t_leaves):
        l = flat[f"leaf_{i}"]
        leaves.append(jax.random.wrap_key_data(jnp.asarray(l)) if _is_key(t) else l)
    return jax.tree.unflatten(treedef, leaves)
