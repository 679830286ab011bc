"""Device-mesh utilities.

The reference's only parallel resource is a single-host rayon pool
(src/mppi.rs:39-50); the scale-out axes here are

- ``rollouts``: MPPI's K sampled sequences sharded across devices (the
  three K-reductions become one pmax/psum log-sum-exp round — SURVEY §2d),
- ``scenario``: thousands of independent closed loops (UKF+MPPI instances)
  batch-sharded across devices (BASELINE north star).

The GPUs of one host are joined all to all by NVLink, so every device
pair is equally close and the mesh shape follows the algorithm alone.
Multi-host extends the same axes via ``jax.distributed.initialize`` with
no code changes.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(axis_sizes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a named mesh, default = all devices on one ``rollouts`` axis.

    ``make_mesh({"scenario": 2, "rollouts": 4})`` builds a 2×4 mesh.
    """
    devices = devices if devices is not None else jax.devices()
    if axis_sizes is None:
        axis_sizes = {"rollouts": len(devices)}
    names = tuple(axis_sizes.keys())
    shape = tuple(axis_sizes.values())
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(shape)
    return Mesh(arr, names)
