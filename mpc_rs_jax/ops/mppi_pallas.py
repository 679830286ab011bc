"""Fused MPPI kernel for NVIDIA GPUs (Pallas through Triton).

One kernel program takes one block of ``bk`` rollouts of one scenario and
does what the reference's rayon pipeline does in five passes over K-sized
buffers (src/mppi.rs:39-84: sample → rollout → max → exp/sum → weighted
average) without writing a K-sized array to device memory:

- noise: a counter-based generator — threefry-2x32 keyed on (seed, stream)
  with the counter (rollout index, step pair) — feeds Box-Muller in
  registers, so the (K, N) sample matrix never exists in HBM;
- rollout: the N-step horizon unrolled over (bk,) vectors, one per state
  component, with the N sampled controls kept for the weighted sum;
- reduction: each block emits log-sum-exp partials (m, s, uw[N]); a small
  XLA merge combines blocks (``merge_blocks``), and the same merge under
  ``pmax``/``psum`` combines devices (parallel/).

``counter_normals`` is the generator in plain ``jax.numpy``: the reference
path (``controllers.mppi.mppi_solve(noise=...)``) draws the same samples
from it (bit-identical words; within ~1e-5 after the compiled kernel's
approximate transcendentals), which is how kernel and reference are
compared.

Grid: (scenario, K-block). Blocks are powers of two (Triton's tensors must
be); exact K is kept by masking rollouts past K, and the horizon is padded
to a power of two only in the (N,) partial written per block.
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from mpc_rs_jax.controllers.mppi import (
    NEG_BIG,
    MppiConfig,
    MppiPartials,
    finalize_partials,
)

_TWO_PI = np.float32(2.0 * math.pi)
_TWO_M24 = np.float32(2.0**-24)
_PI = np.float32(math.pi)
_M2LN2 = np.float32(-2.0 * math.log(2.0))


# ---------------------------------------------------------------------------
# counter-based normals — shared by the kernel body and the plain reference
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds) on uint32 arrays: key (k0, k1), counter
    (c0, c1) → two uint32 words. Bit-identical to JAX's own threefry; uses
    only uint32 add, xor and shifts, so it runs inside a Triton kernel."""
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = c0 + ks[0]
    x1 = c1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _ptx(op: str, x):
    """One PTX approximate-math instruction on an f32 array (GPU only)."""
    return pltriton.elementwise_inline_asm(
        f"{op} $0, $1;", args=[x], constraints="=r,r", pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape, jnp.float32)])[0]


def box_muller(b0, b1, approx: bool = False):
    """Two uint32 words → two independent N(0, 1) floats.

    ``approx`` (compiled GPU kernel only): the hardware's approximate
    lg2/sqrt/sin/cos instead of libdevice's accurate routines, which were
    half of the kernel's time at N=20 on an H100 (PERF.md). The draws then
    differ from the exact transform by at most ~1e-5."""
    u1 = ((b0 >> np.uint32(8)).astype(jnp.int32) + 1).astype(jnp.float32) * _TWO_M24  # (0, 1]
    u2 = (b1 >> np.uint32(8)).astype(jnp.int32).astype(jnp.float32) * _TWO_M24  # [0, 1)
    if not approx:
        r = jnp.sqrt(-2.0 * jnp.log(u1))
        ang = _TWO_PI * u2
        return r * jnp.cos(ang), r * jnp.sin(ang)
    # sin/cos.approx are accurate on [−π, π]: shift the angle by −π and
    # flip the sign back; ln u = lg2 u · ln 2
    r = _ptx("sqrt.approx.f32", _M2LN2 * _ptx("lg2.approx.f32", u1))
    ang = _TWO_PI * u2 - _PI
    return -r * _ptx("cos.approx.f32", ang), -r * _ptx("sin.approx.f32", ang)


def _normals_for(k0, k1, idx, n: int, approx: bool = False):
    """N(0,1) draws for steps 0..n-1 of the rollouts whose global indices
    are ``idx`` (uint32): step t uses counter (idx, t // 2), word t % 2."""
    out = []
    for t0 in range(0, n, 2):
        words = threefry2x32(k0, k1, idx, jnp.full_like(idx, t0 // 2))
        out += box_muller(*words, approx=approx)
    return out[:n]


def counter_normals(seed, stream, k: int, n: int, offset=0) -> jax.Array:
    """The kernel's noise in plain jnp: (k, n) N(0,1) draws of rollouts
    ``offset .. offset+k-1`` under key (seed, stream)."""
    k0 = jnp.asarray(seed).astype(jnp.uint32)
    k1 = jnp.asarray(stream).astype(jnp.uint32)
    idx = (jnp.arange(k, dtype=jnp.int32) + jnp.asarray(offset, jnp.int32)).astype(jnp.uint32)
    return jnp.stack(_normals_for(k0, k1, idx, n), axis=-1)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def default_block(k: int) -> int:
    """Rollouts per program: 128 — one rollout per thread over four warps —
    or K rounded up to a power of two when smaller. On an H100, 128 was the
    fastest or within 4% of it at K=10,240 and K=819,200 among 32…1024,
    and one rollout per thread beat two and four (PERF.md)."""
    return min(128, _next_pow2(k))


def _num_warps(bk: int) -> int:
    return max(1, bk // 32)  # one rollout per thread


def _make_kernel(cfg: MppiConfig, dynamics: Callable, cost: Callable, n_state: int,
                 bk: int, k_total: int, external: bool, approx: bool):
    n = cfg.n_horizon
    n_pad = _next_pow2(n)
    inv = cfg.std_dev ** -2.0 if cfg.control_inv is None else cfg.control_inv
    lo, hi = cfg.limit
    sd = np.float32(cfg.std_dev)
    inv_lambda = np.float32(1.0 / cfg.lambda_)

    def kernel(seed_ref, meta_ref, x0_ref, un_ref, *rest):
        if external:
            eps_ref, m_ref, s_ref, uw_ref = rest
        else:
            m_ref, s_ref, uw_ref = rest
        b = pl.program_id(0)
        i = pl.program_id(1)
        local = i * bk + jax.lax.iota(jnp.int32, bk)
        u = [un_ref[b, t] for t in range(n)]

        # --- sample & clamp (src/mppi.rs:38-45)
        if external:
            eps = [eps_ref[b, t, pl.ds(i * bk, bk)] for t in range(n)]
        else:
            idx = (local + meta_ref[1]).astype(jnp.uint32)
            z = _normals_for(seed_ref[b].astype(jnp.uint32),
                             meta_ref[0].astype(jnp.uint32), idx, n, approx)
            eps = [sd * zt for zt in z]
        v = [jnp.clip(u[t] + eps[t], lo, hi) for t in range(n)]

        # --- rollout + cost + control term (src/mppi.rs:48-62)
        xs = tuple(jnp.full((bk,), x0_ref[b, j], jnp.float32) for j in range(n_state))
        c = jnp.zeros((bk,), jnp.float32)
        ct = jnp.zeros((bk,), jnp.float32)
        for t in range(n):
            xs = dynamics(*xs, v[t])
            c = c + cost(*xs)
            ct = ct + (u[t] * inv) * v[t]
        score = -c - ct

        # --- this block's log-sum-exp partials (src/mppi.rs:65-84)
        valid = jnp.isfinite(score) & (local < k_total)
        m = jnp.max(jnp.where(valid, score, NEG_BIG))
        e = jnp.where(valid, jnp.exp((score - m) * inv_lambda), 0.0)
        m_ref[b, i] = m
        s_ref[b, i] = jnp.sum(e)
        lane = jax.lax.iota(jnp.int32, n_pad)
        uw = jnp.zeros((n_pad,), jnp.float32)
        for t in range(n):
            uw = jnp.where(lane == t, jnp.sum(e * v[t]), uw)
        uw_ref[b, i, :] = uw

    return kernel


def mppi_block_partials(
    cfg: MppiConfig,
    dynamics: Callable,
    cost: Callable,
    n_state: int,
    seeds: jax.Array,
    xs: jax.Array,
    u_ns: jax.Array,
    *,
    n_rollouts: int | None = None,
    stream=0,
    offset=0,
    noise: jax.Array | None = None,
    block: int | None = None,
    interpret: bool = False,
) -> MppiPartials:
    """Per-block partials for a batch of B independent solves.

    ``seeds`` (B,) int32, ``xs`` (B, S), ``u_ns`` (B, N). Scenario b's
    rollout r draws its noise from key (seeds[b], stream) at counter
    offset + r, so a K-sharded solve that gives each device its own
    ``offset`` samples exactly what one device would. ``noise``: optional
    (B, K, N) perturbations (already scaled by σ) that replace the
    generator — the same rows ``mppi_solve(noise=...)`` takes.

    Returns MppiPartials with m, s of shape (B, nb) and uw (B, nb, N).
    """
    b = xs.shape[0]
    k = n_rollouts or cfg.n_rollouts
    n = cfg.n_horizon
    bk = block or default_block(k)
    if bk & (bk - 1):
        raise ValueError(f"block={bk} must be a power of two")
    nb = -(-k // bk)
    external = noise is not None
    ins = [
        jnp.asarray(seeds, jnp.int32).reshape(b),
        jnp.stack([jnp.asarray(stream, jnp.int32), jnp.asarray(offset, jnp.int32)]),
        jnp.asarray(xs, jnp.float32).reshape(b, n_state),
        jnp.asarray(u_ns, jnp.float32).reshape(b, n),
    ]
    if external:
        if noise.shape != (b, k, n):
            raise ValueError(f"noise must have shape (B, K, N) = {(b, k, n)}, got {noise.shape}")
        eps = jnp.swapaxes(jnp.asarray(noise, jnp.float32), 1, 2)  # rollouts contiguous
        ins.append(jnp.pad(eps, ((0, 0), (0, 0), (0, nb * bk - k))))
    m, s, uw = pl.pallas_call(
        # the interpreter has no PTX: it runs the exact transform
        _make_kernel(cfg, dynamics, cost, n_state, bk, k, external, approx=not interpret),
        grid=(b, nb),
        out_shape=[
            jax.ShapeDtypeStruct((b, nb), jnp.float32),
            jax.ShapeDtypeStruct((b, nb), jnp.float32),
            jax.ShapeDtypeStruct((b, nb, _next_pow2(n)), jnp.float32),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_num_warps(bk), num_stages=1),
        interpret=interpret,
        name="mppi_rollout",
    )(*ins)
    return MppiPartials(m=m, s=s, uw=uw[..., :n])


def kernel_normals(seed, stream, k: int, n: int, *, interpret: bool = False) -> jax.Array:
    """The generator exactly as the kernel runs it, written out: (k, n)
    N(0,1) draws from a Triton kernel (k a multiple of 128). Its plain-jnp
    twin is ``counter_normals``."""
    bk = 128
    if k % bk:
        raise ValueError(f"k={k} must be a multiple of {bk}")

    def kernel(key_ref, out_ref):
        i = pl.program_id(0)
        idx = (i * bk + jax.lax.iota(jnp.int32, bk)).astype(jnp.uint32)
        z = _normals_for(key_ref[0].astype(jnp.uint32), key_ref[1].astype(jnp.uint32), idx, n,
                         approx=not interpret)
        for t in range(n):
            out_ref[t, pl.ds(i * bk, bk)] = z[t]

    out = pl.pallas_call(
        kernel,
        grid=(k // bk,),
        out_shape=jax.ShapeDtypeStruct((n, k), jnp.float32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_num_warps(bk), num_stages=1),
        interpret=interpret,
        name="mppi_normals",
    )(jnp.stack([jnp.asarray(seed, jnp.int32), jnp.asarray(stream, jnp.int32)]))
    return out.T


def merge_blocks(parts: MppiPartials, lambda_: float) -> MppiPartials:
    """Log-sum-exp merge over the last partial axis (the K-blocks)."""
    m_g = jnp.max(parts.m, axis=-1)
    scale = jnp.exp((parts.m - m_g[..., None]) / lambda_)
    return MppiPartials(
        m=m_g,
        s=jnp.sum(parts.s * scale, axis=-1),
        uw=jnp.sum(parts.uw * scale[..., None], axis=-2),
    )


def mppi_batch_partials(cfg, dynamics, cost, n_state, seeds, xs, u_ns, **kw) -> MppiPartials:
    """Merged partials of B solves: m, s (B,), uw (B, N)."""
    parts = mppi_block_partials(cfg, dynamics, cost, n_state, seeds, xs, u_ns, **kw)
    return merge_blocks(parts, cfg.lambda_)


def mppi_partials(cfg, dynamics, cost, n_state, seed, x, u_n, *, noise=None, **kw) -> MppiPartials:
    """Merged partials of one solve: m, s scalars, uw (N,)."""
    parts = mppi_batch_partials(
        cfg, dynamics, cost, n_state, jnp.reshape(seed, (1,)), jnp.reshape(x, (1, -1)),
        jnp.reshape(u_n, (1, -1)), noise=None if noise is None else noise[None], **kw,
    )
    return jax.tree.map(lambda a: a[0], parts)


def mppi_solve_pallas(cfg, dynamics, cost, n_state, seed, x, u_n, **kw):
    """One MPPI solve through the kernel: (u_n', status), with the same
    semantics as ``controllers.mppi.mppi_solve`` (zero fallback on failure)."""
    return finalize_partials(cfg, mppi_partials(cfg, dynamics, cost, n_state, seed, x, u_n, **kw), u_n)


def mppi_solve_pallas_batch(cfg, dynamics, cost, n_state, seeds, xs, u_ns, **kw):
    """B solves in one kernel launch: (B, N) sequences and (B,) statuses."""
    parts = mppi_batch_partials(cfg, dynamics, cost, n_state, seeds, xs, u_ns, **kw)
    return jax.vmap(lambda p, u: finalize_partials(cfg, p, u))(parts, u_ns)


def mppi_pallas_chain(
    cfg: MppiConfig,
    dynamics: Callable,
    cost: Callable,
    n_state: int,
    seeds: jax.Array | None,
    x: jax.Array,
    u_n: jax.Array,
    *,
    plant: Callable | None = None,
    n_solves: int | None = None,
    base_seed=0,
    **kw,
):
    """J receding-horizon solves as a ``lax.scan`` of the kernel solve.

    The warm start chains exactly as the reference reuses the returned
    sequence (examples/mppi4.rs:42). With ``plant`` the state advances one
    plant step per solve; otherwise x is held. ``seeds`` (J,) gives each
    solve its own seed; ``seeds=None`` with ``n_solves`` keys solve j on
    (base_seed, stream j).

    Returns (u0s (J,), statuses (J,) int32, final u_n (N,)).
    """
    if seeds is None:
        js = jnp.arange(n_solves, dtype=jnp.int32)
        keyed = (jnp.full_like(js, base_seed), js)
    else:
        seeds = jnp.asarray(seeds, jnp.int32)
        keyed = (seeds, jnp.zeros_like(seeds))

    def body(carry, sj):
        x, u = carry
        u, st = mppi_solve_pallas(cfg, dynamics, cost, n_state, sj[0], x, u, stream=sj[1], **kw)
        if plant is not None:
            x = jnp.stack(plant(*(x[c] for c in range(n_state)), u[0]))
        return (x, u), (u[0], st)

    x = jnp.asarray(x, jnp.float32)
    (_, u_fin), (u0s, sts) = jax.lax.scan(body, (x, jnp.asarray(u_n, jnp.float32)), keyed)
    return u0s, sts, u_fin
