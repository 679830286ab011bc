"""Multi-host bring-up: jax.distributed + one global mesh.

The reference has no distributed backend (SURVEY §2d: rayon work-stealing
on one host). Scale-out here is one global mesh: the MPPI log-sum-exp
collectives run over the ``rollouts`` axis, while scenario data-parallel
needs no cross-device math per scenario, so the slower links between
hosts stay off the critical path.

Single-process usage needs nothing from this module; multi-host jobs call
``init_distributed()`` once per process before any jax op.
"""

from __future__ import annotations

import jax

from mpc_rs_jax.parallel.mesh import make_mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize jax.distributed (no-op if already initialized). Without a
    cluster manager, pass the coordinator address (``host:port``), the
    process count and this process's id."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def global_rollout_mesh(scenario_axis: int = 1):
    """All global devices on (scenario, rollouts); rollouts is the minor
    axis, so a scenario's rollout shards sit on neighbouring devices."""
    n = len(jax.devices())
    if n % scenario_axis:
        raise ValueError(f"{n} devices not divisible by scenario={scenario_axis}")
    return make_mesh({"scenario": scenario_axis, "rollouts": n // scenario_axis})
