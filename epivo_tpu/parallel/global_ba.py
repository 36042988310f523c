"""Global (full-trajectory) bundle adjustment with distributed CG.

The reference only ever solves tiny independent windows (ws=3) and chains
scale between them (`kitti_ba.cpp:853-870,896-903`); it has no global
consistency machinery at all (SURVEY.md §2.3). This module is the
from-scratch scale-out design: ONE joint LM problem over the whole zeta
chain, with

- **local Jacobians**: each constraint touches only its zeta span, so the
  Jacobian is stored as [R, N, S, 6] local blocks (S = max span width) plus
  an index map — never the dense [R*N, 6Z] matrix;
- **matrix-free damped normal equations**: H v is evaluated as
  sum_r J_r^T (J_r v[span_r]) via gather/scatter-add — the block-banded
  structure of the pose-only problem (the landmark-free parametrization has
  no landmark block, so no Schur complement is *needed*; the camera-system
  reduction the reference's north star asks for is exactly this reduced
  pose system);
- **conjugate gradients** with Jacobi preconditioning for the solve;
- **distribution**: constraints shard across the mesh ('win' axis); every
  matvec / gradient / energy reduces with one psum; the pose state
  (6Z floats) is replicated — for trajectories this is tiny.

Single-device semantics == ``optim.lm.solve`` up to the inexact CG solve;
the multi-device path is validated 1-vs-8 devices in tests.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from epivo_tpu.geometry import epipolar, se3


class GlobalBAResult(NamedTuple):
    T0s: jnp.ndarray  # [Z, 4, 4]
    r_norm: jnp.ndarray  # []
    n_accepted: jnp.ndarray  # []
    lam: jnp.ndarray  # []


def _span_data(reps: np.ndarray, max_span: int):
    """Static per-constraint span indexing: (zidx [R, S], zmask [R, S])."""
    z0 = reps[:, 0]
    z1 = reps[:, 1]
    lo = np.minimum(z0, z1)
    hi = np.maximum(z0, z1)
    S = max_span
    assert int((hi - lo).max()) + 1 <= S, "constraint span exceeds max_span"
    zidx = lo[:, None] + np.arange(S)[None, :]
    zmask = zidx <= hi[:, None]
    zidx = np.minimum(zidx, hi[:, None])  # clamp (masked anyway)
    return zidx.astype(np.int32), zmask


def _local_system(T0s, reps, zidx, zmask, wreps, p, p_t, huber_delta, pmask):
    """Residuals and *local* Jacobian blocks for a shard of constraints.

    Returns (r [R, N], J [R, N, S, 6]) pre-weighted.
    """
    Z = T0s.shape[0]
    T0_mem = se3.prefix_products(T0s)  # [Z, Z, 4, 4] (replicated state)

    z0 = reps[:, 0]
    z1 = reps[:, 1]
    rev = z0 > z1
    lo = jnp.minimum(z0, z1)
    hi = jnp.maximum(z0, z1)
    T_fwd = T0_mem[lo, hi]
    T0r = jnp.where(rev[:, None, None], se3.inverse(T_fwd), T_fwd)

    r = epipolar.residual_from_T(T0r, p, p_t, huber_delta, pmask)
    r = r * wreps[:, None]

    # Tl/Tr per (constraint, span slot) — same dispatch as optim.lm but
    # only over the S-wide local span.
    k = zidx  # [R, S] global zeta ids
    z0g = jnp.broadcast_to(z0[:, None], k.shape)
    z1g = jnp.broadcast_to(z1[:, None], k.shape)
    eye = jnp.eye(4, dtype=T0s.dtype)
    Tl_f = T0_mem[k, jnp.maximum(z1g, k)]
    Tr_f = jnp.where((k > z0g)[..., None, None],
                     T0_mem[z0g, jnp.maximum(k - 1, 0)], eye)
    Tl_r = se3.inverse(T0_mem[z1g, jnp.maximum(k, z1g)])
    Tr_r = jnp.where((k < z0g)[..., None, None],
                     se3.inverse(T0_mem[jnp.minimum(k + 1, Z - 1), z0g]), eye)
    rev_b = rev[:, None, None, None]
    Tl = jnp.where(rev_b, Tl_r, Tl_f)
    Tr = jnp.where(rev_b, Tr_r, Tr_f)

    pm = pmask if pmask is not None else jnp.ones(p.shape[:2], bool)
    jac = jax.vmap(
        jax.vmap(epipolar.residual_jacobian,
                 in_axes=(0, 0, None, None, None, None, None)),
        in_axes=(0, 0, 0, 0, 0, None, 0),
    )
    J = jac(Tl, Tr, p, p_t, rev, huber_delta, pm)  # [R, S, N, 6]
    J = jnp.swapaxes(J, 1, 2)  # [R, N, S, 6]
    J = J * zmask[:, None, :, None] * wreps[:, None, None, None]
    return r, J


def _matvec(J, zidx, v, axis_name=None):
    """Damped-Gauss-Newton matvec: (J^T J) v with local blocks.

    J [R, N, S, 6]; v [Z, 6]. Returns [Z, 6] (psum'd over axis_name).
    """
    v_loc = v[zidx]  # [R, S, 6]
    Jv = jnp.einsum("rnsk,rsk->rn", J, v_loc)
    JtJv_loc = jnp.einsum("rnsk,rn->rsk", J, Jv)  # [R, S, 6]
    Z = v.shape[0]
    out = jnp.zeros_like(v).at[zidx].add(JtJv_loc)
    if axis_name is not None:
        out = jax.lax.psum(out, axis_name)
    return out


def _rhs_and_diag(J, r, zidx, Z, axis_name=None):
    b = jnp.zeros((Z, 6), J.dtype).at[zidx].add(
        jnp.einsum("rnsk,rn->rsk", J, r)
    )
    diag = jnp.zeros((Z, 6), J.dtype).at[zidx].add(
        jnp.einsum("rnsk,rnsk->rsk", J, J)
    )
    if axis_name is not None:
        b = jax.lax.psum(b, axis_name)
        diag = jax.lax.psum(diag, axis_name)
    return b, diag


def _pcg(matvec, b, diag, lam, iters):
    """Jacobi-preconditioned CG for (JtJ + lam*diag(JtJ) + eps) x = -b."""
    damp = lam * diag + 1e-7 * (jnp.mean(diag) + 1e-30)

    def A(v):
        return matvec(v) + damp * v

    Minv = 1.0 / jnp.maximum(diag + damp, 1e-30)
    x = jnp.zeros_like(b)
    r = -b  # residual of A x + b = 0 at x=0
    z = Minv * r
    p_dir = z
    rz = jnp.sum(r * z)

    def body(carry, _):
        x, r, p_dir, rz = carry
        Ap = A(p_dir)
        alpha = rz / jnp.maximum(jnp.sum(p_dir * Ap), 1e-30)
        x = x + alpha * p_dir
        r = r - alpha * Ap
        z = Minv * r
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p_new = z + beta * p_dir
        return (x, r, p_new, rz_new), None

    (x, _, _, _), _ = jax.lax.scan(body, (x, r, p_dir, rz), None, length=iters)
    return x


def global_ba_solve(
    T0s: jnp.ndarray,
    reps: np.ndarray,
    p: jnp.ndarray,
    p_t: jnp.ndarray,
    wreps: jnp.ndarray | None = None,
    pmask: jnp.ndarray | None = None,
    max_span: int = 4,
    lambda0: float = 1e-2,
    max_iters: int = 20,
    cg_iters: int = 32,
    huber_delta: float = 1.0,
    mesh: Mesh | None = None,
    axis_name: str = "win",
) -> GlobalBAResult:
    """Joint LM over the full zeta chain; optionally constraint-sharded.

    Args:
      T0s: [Z, 4, 4] initial chain.
      reps: [R, 2] spans (|z1 - z0| + 1 <= max_span).
      p, p_t: [R, N, 3] matches; wreps [R]; pmask [R, N].
      mesh: if given, the R axis is sharded over mesh axis ``axis_name``
        and all reductions become psums (R must divide evenly;
        pad with wreps=0 constraints if needed).
    """
    Z = T0s.shape[0]
    R_ = reps.shape[0]
    dtype = T0s.dtype
    reps_np = np.asarray(reps, np.int32)
    zidx_np, zmask_np = _span_data(reps_np, max_span)
    if wreps is None:
        wreps = jnp.ones((R_,), dtype)
    pm = pmask if pmask is not None else jnp.ones(p.shape[:2], bool)

    def energy(Ts, reps_j, pj, ptj, wj, pmj, axis=None):
        T0_mem = se3.prefix_products(Ts)
        z0, z1 = reps_j[:, 0], reps_j[:, 1]
        lo = jnp.minimum(z0, z1)
        hi = jnp.maximum(z0, z1)
        T_f = T0_mem[lo, hi]
        T0r = jnp.where((z0 > z1)[:, None, None], se3.inverse(T_f), T_f)
        r = epipolar.residual_from_T(T0r, pj, ptj, huber_delta, pmj)
        e = jnp.sum((r * wj[:, None]) ** 2)
        if axis is not None:
            e = jax.lax.psum(e, axis)
        return e

    def lm_loop(reps_j, zidx_j, zmask_j, pj, ptj, wj, pmj, axis=None):
        def step(carry, _):
            Ts, lam, prev_E, n_acc = carry
            r, J = _local_system(Ts, reps_j, zidx_j, zmask_j, wj, pj, ptj,
                                 huber_delta, pmj)
            b, diag = _rhs_and_diag(J, r, zidx_j, Z, axis)
            mv = lambda v: _matvec(J, zidx_j, v, axis)
            delta = _pcg(mv, b, diag, lam, cg_iters)  # [Z, 6]
            bad = jnp.any(~jnp.isfinite(delta))
            delta = jnp.where(bad, jnp.zeros_like(delta), delta)
            Ts_cand = jnp.einsum("zij,zjk->zik", Ts, se3.se3_exp(delta))
            cand_E = energy(Ts_cand, reps_j, pj, ptj, wj, pmj, axis)
            accept = (cand_E < prev_E) & ~bad
            Ts_new = jnp.where(accept, Ts_cand, Ts)
            return (
                Ts_new,
                jnp.where(accept, lam / 2.0, lam * 5.0),
                jnp.where(accept, cand_E, prev_E),
                n_acc + accept.astype(jnp.int32),
            ), None

        E0 = energy(T0s, reps_j, pj, ptj, wj, pmj, axis)
        carry0 = (T0s, jnp.asarray(lambda0, dtype), E0,
                  jnp.asarray(0, jnp.int32))
        (Ts, lam, E, n_acc), _ = jax.lax.scan(step, carry0, None,
                                              length=max_iters)
        return GlobalBAResult(T0s=Ts, r_norm=jnp.sqrt(E), n_accepted=n_acc,
                              lam=lam)

    reps_j = jnp.asarray(reps_np)
    zidx_j = jnp.asarray(zidx_np)
    zmask_j = jnp.asarray(zmask_np)

    if mesh is None:
        return jax.jit(
            lambda: lm_loop(reps_j, zidx_j, zmask_j, p, p_t, wreps, pm,
                            axis=None)
        )()

    n_dev = mesh.shape[axis_name]
    assert R_ % n_dev == 0, (
        f"constraint count {R_} must divide the mesh axis {n_dev}; "
        "pad with zero-weight constraints"
    )
    shard = functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(axis_name), P(axis_name), P(axis_name)),
        out_specs=GlobalBAResult(T0s=P(), r_norm=P(), n_accepted=P(), lam=P()),
        check_vma=False,
    )

    fn = shard(
        lambda a, b_, c, d, e, f, g: lm_loop(a, b_, c, d, e, f, g,
                                             axis=axis_name)
    )
    return jax.jit(fn)(reps_j, zidx_j, zmask_j, p, p_t, wreps, pm)
