"""Scenario-parallel batched closed loops over a 2-D (scenario × rollouts)
mesh — the BASELINE "north star": thousands of independent MPPI+UKF control
loops, each loop's K rollouts additionally sharded across chips.

SPMD layout:
- axis ``scenario``: independent closed-loop instances (pure data parallel,
  no cross-device math — the UKF stays per-device, SURVEY §5),
- axis ``rollouts``: each scenario's K MPPI samples split across devices;
  the softmax reduction is one pmax/psum log-sum-exp round.

States are sharded P('scenario') over leading batch dim and replicated
over 'rollouts'; controls come back replicated over 'rollouts'.

Backends: 'pallas' runs all local scenarios' MPPI in one scenario-batched
fused kernel launch (ops.mppi_pallas.mppi_batch_partials); 'jnp' uses the
vmap reference path (CPU meshes, parity tests).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from mpc_rs_jax.controllers.mppi import MppiConfig, finalize_partials
from mpc_rs_jax.estimators.ukf import UkfParams, UkfState, ukf_guard, ukf_predict, ukf_update
from mpc_rs_jax.ops.mppi_pallas import mppi_batch_partials
from mpc_rs_jax.parallel.sharded_mppi import _jnp_partials, merge_devices


class ScenarioCarry(NamedTuple):
    x: jax.Array  # (B, S) true plant states
    u_n: jax.Array  # (B, N) nominal sequences
    ukf: UkfState  # batched (leading B) estimator state
    key: jax.Array  # (B,) per-scenario PRNG keys
    status: jax.Array  # (B,) last MPPI status
    t: jax.Array  # (B,) sim time — drives disturbance windows


def make_scenario_step(
    cfg: MppiConfig,
    dynamics,  # component-wise controller model
    cost,
    plant_fx: Callable,  # vector form (x, u) -> x  — true plant
    ukf_params: UkfParams,
    ukf_fx: Callable,
    ukf_hx: Callable,
    sensor_stddevs,
    mesh: Mesh,
    *,
    scenario_axis: str = "scenario",
    rollout_axis: str = "rollouts",
    state_slice=None,  # e.g. 6-state estimate -> 4-state controller input
    backend: str = "jnp",
    n_state: int | None = None,
    feed_true_state: bool = False,
    n_substeps: int = 1,
    dt_tick: float = 0.0,
    disturbance: Callable | None = None,
    control_start: float = 0.0,
    ukf_p_reset=None,  # enables per-instance NaN recovery (ukf_guard)
    interpret: bool = False,  # run the batched kernel in the Pallas interpreter (CPU)
    ukf_layout: str = "aos",  # "aos": vmapped estimators.ukf; "soa": batch-minor
    ukf_fx_c: Callable | None = None,  # component-form fx (required for "soa")
    ukf_hx_c: Callable | None = None,  # component-form hx (required for "soa")
):
    """Returns jitted ``step(carry) -> carry`` advancing every scenario one
    control tick: MPPI (rollout-sharded) → plant → sensor → UKF.

    ``feed_true_state`` reproduces the reference's DEBUG_UKF switch
    (examples/mppi4-non-liner-ukf.rs:31,55-61): the controller sees the true
    plant state while the estimator still runs alongside.

    ``n_substeps`` models the reference's sensor/UKF threads ticking faster
    than the control loop (sensor every 3–9 ms vs control every 0.1 s —
    examples/mppi4-non-liner-s.rs:231-240): per control tick the plant and
    the sensor→UKF update run ``n_substeps`` times while ``u0`` is held.
    ``plant_fx``/``ukf_fx`` must then be built at the substep dt.

    ``disturbance``: traceable ``f(t_sim) -> force`` (e.g. the flagship's
    2 N push during t∈(1,1.5) s — mppi4-non-liner-ukf.rs:237-244). When
    given, ``plant_fx`` is called as ``plant_fx(x, u, f)`` and ``dt_tick``
    must be the control-tick period (sim time advances by it each tick).

    ``ukf_layout="soa"``: run the estimator in the batch-minor layout
    (estimators/ukf_soa.py — every matrix entry a (B,) vector, so each
    UKF operation is one wide elementwise op instead of B tiny 6×6 ones).
    Requires component-form ``ukf_fx_c``/``ukf_hx_c``; the carry keeps the
    standard batch-leading ``UkfState`` (checkpoint/sharding compatible) —
    conversion happens inside the tick. The sensor-noise key schedule
    differs from the AoS path (same statistics), so trajectories are not
    bit-comparable across layouts; survival/acceptance gates both.
    """
    n_dev_r = mesh.shape[rollout_axis]
    if cfg.n_rollouts % n_dev_r:
        raise ValueError("K not divisible by rollout axis")
    if ukf_layout == "soa" and (ukf_fx_c is None or ukf_hx_c is None):
        raise ValueError("ukf_layout='soa' requires component-form ukf_fx_c and ukf_hx_c")
    k_local = cfg.n_rollouts // n_dev_r
    sig = jnp.asarray(sensor_stddevs)
    if n_state is None:
        n_state = len(state_slice) if state_slice is not None else None

    def shard_fn(carry: ScenarioCarry) -> ScenarioCarry:
        my_r = jax.lax.axis_index(rollout_axis)

        keys = jax.vmap(lambda k: jax.random.split(k, 3))(carry.key)
        key_next, k_mppi, k_sens = keys[:, 0], keys[:, 1], keys[:, 2]
        x_ctrl = carry.x if feed_true_state else carry.ukf.x
        x_hats = x_ctrl if state_slice is None else x_ctrl[:, jnp.asarray(state_slice)]

        if backend == "pallas":
            ns = n_state if n_state is not None else x_hats.shape[-1]
            # one seed per scenario; each rollout shard takes its own slice
            # of the scenario's counter space
            seeds = jax.vmap(
                lambda k: jax.random.randint(k, (), 0, 2**31 - 1, dtype=jnp.int32)
            )(k_mppi)
            parts = mppi_batch_partials(
                cfg, dynamics, cost, ns, seeds, x_hats, carry.u_n, n_rollouts=k_local,
                offset=my_r * k_local, interpret=interpret,
            )
        else:
            # decorrelate rollout shards; scenarios decorrelate via their keys
            k_mppi = jax.vmap(lambda k: jax.random.fold_in(k, my_r))(k_mppi)
            parts = jax.vmap(
                lambda k, xh, u: _jnp_partials(
                    cfg, dynamics, cost, k, tuple(xh), u, k_local
                )
            )(k_mppi, x_hats, carry.u_n)
        parts = merge_devices(parts, cfg.lambda_, rollout_axis)
        u_new, status = jax.vmap(lambda p, u: finalize_partials(cfg, p, u))(parts, carry.u_n)

        dt_sub = dt_tick / n_substeps

        def rest(x, u_seq, ukf, ks, t):
            u0 = u_seq[0]
            if control_start > 0.0:
                # estimator-settling window: plant coasts (u=0) while the
                # sensor->UKF chain runs, as the reference's UKF thread does
                # during control-thread startup (mppi4-non-liner-ukf.rs:224-288)
                u0 = jnp.where(t >= jnp.float32(control_start), u0, 0.0)

            def substep(c, inp):
                x, ukf = c
                kss, i = inp
                if disturbance is None:
                    x_next = plant_fx(x, u0)
                else:
                    x_next = plant_fx(x, u0, disturbance(t + i * dt_sub))
                z = ukf_hx(x_next) + sig * jax.random.normal(kss, sig.shape, dtype=sig.dtype)
                ukf = ukf_predict(ukf_params, ukf, u0, ukf_fx)
                ukf = ukf_update(ukf_params, ukf, z, ukf_hx)
                if ukf_p_reset is not None:
                    ukf = ukf_guard(ukf, ukf_p_reset)
                return (x_next, ukf), None

            if n_substeps == 1:
                (x_next, ukf), _ = substep((x, ukf), (ks, jnp.float32(0.0)))
            else:
                (x_next, ukf), _ = jax.lax.scan(
                    substep,
                    (x, ukf),
                    (jax.random.split(ks, n_substeps), jnp.arange(n_substeps, dtype=jnp.float32)),
                )
            return x_next, ukf

        def rest_soa(x, u_seq, ukf, ks, t):
            """Batch-level plant/sensor/UKF substeps with the estimator in
            the batch-minor layout — no vmap; every UKF op is one (B,)
            vector op. The plant and hx run vector-form on (B, n) (their
            internals slice components)."""
            from mpc_rs_jax.estimators import ukf_soa as _soa

            u0 = u_seq[:, 0]
            if control_start > 0.0:
                u0 = jnp.where(t >= jnp.float32(control_start), u0, 0.0)
            # q/r are the fleets' per-init constants (identical across the
            # batch by construction — init_scenario_carry broadcasts one)
            q_const, r_const = ukf.q[0], ukf.r[0]
            n_obs = r_const.shape[-1]
            # Carry-native SoA (init_scenario_carry(ukf_layout="soa")): the
            # covariance lives in the carry packed batch-minor as one
            # (n², B) array and sigma_f is dropped entirely (predict always
            # precedes update inside a tick, so cross-tick sigma_f is dead
            # state). The legacy batch-leading carry pays ~230 strided
            # slice/stack ops per tick for the (B,6,6)/(B,13,6) layout
            # conversions.
            n_st = ukf.x.shape[-1]
            native = getattr(ukf.p, "ndim", 3) == 2
            b = ukf.x.shape[0]
            # Dense-tile entry shape: every SoA entry reshaped to
            # (B/128, 128), gated on n_substeps == 1. This tiling was chosen
            # for an earlier accelerator's (8, 128) vector tiles and is kept
            # as plain jnp until it is re-measured on the GPU (ROADMAP).
            tiled = native and b % 128 == 0 and n_substeps == 1
            e_shape = (b // 128, 128) if tiled else (b,)
            ecomp = (lambda a: a.reshape(e_shape)) if tiled else (lambda a: a)
            if native:
                soa = _soa.SoaUkfState(
                    x=tuple(ecomp(ukf.x[:, i]) for i in range(n_st)),
                    p=tuple(
                        tuple(ecomp(ukf.p[i * n_st + j]) for j in range(n_st))
                        for i in range(n_st)
                    ),
                    # dead placeholder: overwritten by the first predict,
                    # present only to keep the scan carry structure static
                    sigma_f=tuple(
                        jnp.zeros((2 * n_st + 1,) + e_shape, ukf.x.dtype)
                        for _ in range(n_st)
                    ),
                )
            else:
                soa = _soa.from_batched(ukf.x, ukf.p, ukf.sigma_f)

            u0_e = ecomp(u0)

            def substep(c, inp):
                x, soa = c
                kss, i = inp
                if disturbance is None:
                    x_next = plant_fx(x, u0)
                else:
                    x_next = plant_fx(x, u0, disturbance(t + i * dt_sub))
                zmat = ukf_hx(x_next) + sig * jax.random.normal(
                    kss, x_next.shape[:-1] + sig.shape, dtype=sig.dtype
                )
                soa = _soa.soa_predict(ukf_params, soa, u0_e, ukf_fx_c, q_const)
                soa = _soa.soa_update(
                    ukf_params, soa,
                    tuple(ecomp(zmat[..., j]) for j in range(n_obs)),
                    ukf_hx_c, r_const,
                )
                if ukf_p_reset is not None:
                    soa = _soa.soa_guard(soa, jnp.asarray(ukf_p_reset))
                return (x_next, soa), None

            keys = jax.random.split(ks[0], n_substeps)  # shared sensor-noise
            # schedule root; per-substep keys draw (B, o) noise at once
            if n_substeps == 1:
                (x_next, soa), _ = substep((x, soa), (keys[0], jnp.float32(0.0)))
            else:
                (x_next, soa), _ = jax.lax.scan(
                    substep, (x, soa),
                    (keys, jnp.arange(n_substeps, dtype=jnp.float32)),
                )
            if native:
                return x_next, ukf._replace(
                    x=jnp.stack([e.reshape(b) for e in soa.x], axis=-1),
                    p=jnp.stack(
                        [soa.p[i][j].reshape(b)
                         for i in range(n_st) for j in range(n_st)]
                    ),
                )
            xb, pb, sfb = _soa.to_batched(soa)
            return x_next, ukf._replace(x=xb, p=pb, sigma_f=sfb)

        if ukf_layout == "soa":
            x_next, ukf = rest_soa(carry.x, u_new, carry.ukf, k_sens, carry.t)
        else:
            x_next, ukf = jax.vmap(rest)(carry.x, u_new, carry.ukf, k_sens, carry.t)
        return ScenarioCarry(
            x=x_next, u_n=u_new, ukf=ukf, key=key_next, status=status,
            t=carry.t + jnp.float32(dt_tick),
        )

    spec_b = P(scenario_axis)  # batch-leading arrays: sharded over scenario,
    # replicated over rollouts (each rollout-shard sees the whole sub-batch)
    if ukf_layout == "soa":
        # carry-native SoA: p is packed batch-MINOR (n², B) → scenario is
        # axis 1; sigma_f is dropped (None ≡ empty subtree in both trees)
        ukf_spec = UkfState(x=spec_b, p=P(None, scenario_axis), q=spec_b,
                            r=spec_b, sigma_f=None)
    else:
        ukf_spec = jax.tree.map(lambda _: spec_b, UkfState(*(0,) * 5))
    specs = ScenarioCarry(x=spec_b, u_n=spec_b, ukf=ukf_spec, key=spec_b,
                          status=spec_b, t=spec_b)
    step = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(specs,),
        out_specs=specs,
        check_vma=False,
    )
    return jax.jit(step)


def init_scenario_carry(batch, x0, u0, ukf_state: UkfState, key,
                        ukf_layout: str = "aos"):
    """Broadcast a single-scenario initial condition to a (B, ...) carry.

    ``ukf_layout="soa"``: store the estimator covariance carry-native in
    the batch-minor layout — ``ukf.p`` packed as one (n², B) array,
    ``ukf.sigma_f`` None (dead across ticks: predict precedes update).
    ``ukf.x`` stays (B, n) batch-leading — it feeds the controller and the
    fleet diagnostics, and converting n entries is negligible; only the
    O(n²)+O(mn) covariance/sigma conversions cost real tick time."""
    tile = lambda a: jnp.broadcast_to(jnp.asarray(a), (batch,) + jnp.asarray(a).shape)
    ukf = jax.tree.map(tile, ukf_state)
    if ukf_layout == "soa":
        n = ukf.x.shape[-1]
        flat = jnp.asarray(ukf_state.p).reshape(n * n)
        ukf = ukf._replace(
            p=jnp.broadcast_to(flat[:, None], (n * n, batch)),
            sigma_f=None,
        )
    return ScenarioCarry(
        x=tile(x0),
        u_n=tile(u0),
        ukf=ukf,
        key=jax.random.split(key, batch),
        status=jnp.zeros((batch,), jnp.int32),
        t=jnp.zeros((batch,), jnp.float32),
    )
