"""Levenberg-Marquardt over SE(3) pose chains — the optimizer core.

Re-design of the reference's ``Levenberg_Marquardt``
(`jac_Rt_gen_.cpp:287-478`) + ``RepJacobian::compute`` (`:262-284`) +
``T0_mem`` prefix cache (`:18-20,327-335`):

- fixed-iteration ``lax.scan`` with masked accept/reject instead of
  data-dependent control flow (the reference caps at 30 iterations anyway);
- the prefix pose cache is a functional ``se3.prefix_products`` tensor;
- the Jacobian assembly is one batched computation over (rep, zeta) pairs
  with a static participation mask instead of nested block-copy loops
  (`jac_Rt_gen_.cpp:363-399`);
- damped normal equations are solved with a linear solve, never the explicit
  inverse of `jac_Rt_gen_.cpp:405`;
- NaN guard (`:407-410`), early-exit on small steps (`:412-414`), and the
  accept/reject lambda schedule /2 x5 (`:456-467`) are preserved as masks;
- everything vmaps over a leading window axis, making windowed BA
  embarrassingly parallel per chip and shardable across a mesh.

Deviations from the reference (deliberate):
- accept/reject energy uses *weighted* residuals, so w=0 (frozen) constraints
  with placeholder points cannot pollute the decision (the reference compares
  unweighted candidate residuals, `jac_Rt_gen_.cpp:444-456`);
- an optional ``zeta_mask`` can freeze specific poses exactly (e.g. a known
  stereo baseline), which the reference approximates by zero-weighting the
  constraint but still lets the pose drift.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from epivo_tpu.geometry import epipolar, se3


class LMResult(NamedTuple):
    """Solver health signals (superset of the reference's ``LM_res``,
    `jac_Rt_gen_.cpp:473-475`)."""

    T0s: jnp.ndarray  # [Z, 4, 4] optimized poses
    r_norm: jnp.ndarray  # [] final residual norm (weighted)
    H_norm: jnp.ndarray  # [] Frobenius norm of last damped Hessian
    lam: jnp.ndarray  # [] final damping
    n_accepted: jnp.ndarray  # [] int, accepted steps
    converged: jnp.ndarray  # [] bool, hit the small-step exit


def _compose_reps(T0_mem: jnp.ndarray, reps: jnp.ndarray) -> jnp.ndarray:
    """Composed pose per reprojection span: forward product or inverse
    (ref `jac_Rt_gen_.cpp:338-348`). reps [R,2] int32; returns [R,4,4]."""
    z0, z1 = reps[:, 0], reps[:, 1]
    lo = jnp.minimum(z0, z1)
    hi = jnp.maximum(z0, z1)
    fwd = T0_mem[lo, hi]  # [R, 4, 4]
    return jnp.where((z0 <= z1)[:, None, None], fwd, se3.inverse(fwd))


def _zeta_frames(T0_mem: jnp.ndarray, reps: jnp.ndarray, Z: int):
    """Left/right composed transforms around each (rep, zeta) pair.

    Vectorized equivalent of ``RepJacobian::compute`` (`jac_Rt_gen_.cpp:262-284`):

    forward (z0 <= z1), zeta k in [z0, z1]:
        Tl = T0_mem[k, z1]           (includes k)
        Tr = T0_mem[z0, k-1]         (identity when k == z0)
    reverse (z0 > z1), zeta k in [z1, z0]:
        Tl = inv(T0_mem[z1, k])      (includes k)
        Tr = inv(T0_mem[k+1, z0])    (identity when k == z0)

    Returns (Tl [R,Z,4,4], Tr [R,Z,4,4], participate [R,Z] bool, reverse [R] bool).
    """
    R_ = reps.shape[0]
    z0, z1 = reps[:, 0], reps[:, 1]  # [R]
    rev = z0 > z1
    ks = jnp.arange(Z)  # [Z]
    lo = jnp.minimum(z0, z1)[:, None]
    hi = jnp.maximum(z0, z1)[:, None]
    part = (ks[None, :] >= lo) & (ks[None, :] <= hi)  # [R, Z]

    k_grid = jnp.broadcast_to(ks[None, :], (R_, Z))
    z0g = jnp.broadcast_to(z0[:, None], (R_, Z))
    z1g = jnp.broadcast_to(z1[:, None], (R_, Z))

    # Forward entries (indices clamped; masked out where not participating).
    Tl_f = T0_mem[k_grid, jnp.maximum(z1g, k_grid)]
    Tr_f = jnp.where(
        (k_grid > z0g)[..., None, None],
        T0_mem[z0g, jnp.maximum(k_grid - 1, 0)],
        jnp.eye(4, dtype=T0_mem.dtype),
    )
    # Reverse entries.
    Tl_r = se3.inverse(T0_mem[z1g, jnp.maximum(k_grid, z1g)])
    Tr_r = jnp.where(
        (k_grid < z0g)[..., None, None],
        se3.inverse(T0_mem[jnp.minimum(k_grid + 1, Z - 1), z0g]),
        jnp.eye(4, dtype=T0_mem.dtype),
    )

    rev_b = rev[:, None, None, None]
    Tl = jnp.where(rev_b, Tl_r, Tl_f)
    Tr = jnp.where(rev_b, Tr_r, Tr_f)
    return Tl, Tr, part, rev


def build_system(
    T0s: jnp.ndarray,
    reps: jnp.ndarray,
    wreps: jnp.ndarray,
    p: jnp.ndarray,
    p_t: jnp.ndarray,
    huber_delta: float,
    pmask: jnp.ndarray | None = None,
):
    """Assemble weighted residual stack and Jacobian.

    Args:
      T0s: [Z, 4, 4] current poses.
      reps: [R, 2] zeta spans.
      wreps: [R] constraint weights (w=0 freezes, ref `kitti_ba.cpp:567-574`).
      p, p_t: [R, N, 3] matches.
      pmask: optional [R, N] point validity.

    Returns:
      (r [R, N], J [R, N, Z, 6]) both pre-multiplied by wreps.
    """
    Z = T0s.shape[0]
    T0_mem = se3.prefix_products(T0s)  # [Z, Z, 4, 4]
    T0r = _compose_reps(T0_mem, reps)  # [R, 4, 4]

    r = epipolar.residual_from_T(T0r, p, p_t, huber_delta, pmask)  # [R, N]
    r = r * wreps[:, None]

    Tl, Tr, part, rev = _zeta_frames(T0_mem, reps, Z)
    # vmap over rep and zeta axes; points broadcast per rep.
    jac = jax.vmap(  # over reps
        jax.vmap(  # over zetas
            epipolar.residual_jacobian,
            in_axes=(0, 0, None, None, None, None, None),
        ),
        in_axes=(0, 0, 0, 0, 0, None, 0),
    )
    pm = pmask if pmask is not None else jnp.ones(p.shape[:2], dtype=bool)
    J = jac(Tl, Tr, p, p_t, rev, huber_delta, pm)  # [R, Z, N, 6]
    J = jnp.swapaxes(J, 1, 2)  # [R, N, Z, 6]
    J = J * part[:, None, :, None] * wreps[:, None, None, None]
    return r, J


def solve(
    T0s: jnp.ndarray,
    reps: jnp.ndarray,
    p: jnp.ndarray,
    p_t: jnp.ndarray,
    wreps: jnp.ndarray | None = None,
    pmask: jnp.ndarray | None = None,
    zeta_mask: jnp.ndarray | None = None,
    lambda0: float = 1e-2,
    epsilon: float = 1e-8,
    max_iters: int = 30,
    huber_delta: float = epipolar.DEFAULT_HUBER_DELTA,
) -> LMResult:
    """Joint LM optimization of a pose chain over reprojection constraints.

    Drop-in functional equivalent of the reference solver
    (`jac_Rt_gen_.cpp:287-478`); jit/vmap-safe, fixed shapes throughout.

    Args:
      T0s: [Z, 4, 4] initial zeta poses.
      reps: [R, 2] int32 (z0, z1) spans (z0 > z1 means reversed chain).
      p, p_t: [R, N, 3] matched normalized points per constraint.
      wreps: [R] weights (default 1).
      pmask: [R, N] optional point validity.
      zeta_mask: [Z] optional; False freezes that pose exactly.
      lambda0 / epsilon / max_iters: LM schedule (ref defaults 1e-2 / 1e-8 / 30).
    """
    Z = T0s.shape[0]
    R_ = reps.shape[0]
    dtype = T0s.dtype
    reps = jnp.asarray(reps, jnp.int32)
    if wreps is None:
        wreps = jnp.ones((R_,), dtype)
    wreps = jnp.asarray(wreps, dtype)
    zmask = (
        jnp.ones((Z,), dtype=bool) if zeta_mask is None else jnp.asarray(zeta_mask)
    )

    def energy(Ts):
        T0_mem = se3.prefix_products(Ts)
        T0r = _compose_reps(T0_mem, reps)
        r = epipolar.residual_from_T(T0r, p, p_t, huber_delta, pmask) * wreps[:, None]
        return jnp.linalg.norm(r.reshape(-1)), r

    init_E = jnp.asarray(jnp.inf, dtype)

    def step(carry, _):
        Ts, lam, prev_E, H_norm, n_acc, done = carry

        r, J = build_system(Ts, reps, wreps, p, p_t, huber_delta, pmask)
        r_flat = r.reshape(-1)  # [R*N]
        J_flat = J.reshape(r_flat.shape[0], Z * 6)

        b = J_flat.T @ r_flat
        H = J_flat.T @ J_flat
        diag = jnp.diagonal(H)
        H_damped = H + lam * jnp.diag(diag)
        # Tikhonov floor keeps the solve well-posed when a zeta has no
        # constraints (the reference would produce inf/NaN and bail). The
        # floor must be RELATIVE to H's scale: with the reference's
        # huber_delta=1e-5 the residuals (and hence H) can sit at ~1e-10,
        # where any absolute floor would drown the actual curvature.
        h_scale = jnp.mean(diag) + 1e-30
        H_damped = H_damped + (1e-7 * h_scale) * jnp.eye(Z * 6, dtype=dtype)
        # Unrolled SPD Cholesky in place of a batched tiny LU (see
        # optim/smallchol.py).
        from epivo_tpu.optim import smallchol

        delta = -smallchol.solve_spd_small(H_damped, b)

        nan_step = jnp.any(~jnp.isfinite(delta))
        small_step = jnp.linalg.norm(delta) < epsilon
        delta = jnp.where(nan_step, jnp.zeros_like(delta), delta)

        dT = se3.se3_exp(delta.reshape(Z, 6))
        Ts_cand = jnp.einsum("zij,zjk->zik", Ts, dT)
        Ts_cand = jnp.where(zmask[:, None, None], Ts_cand, Ts)

        cand_E, _ = energy(Ts_cand)
        accept = (cand_E < prev_E) & ~nan_step & ~small_step & ~done

        Ts_new = jnp.where(accept, Ts_cand, Ts)
        prev_E_new = jnp.where(accept, cand_E, prev_E)
        lam_new = jnp.where(done, lam, jnp.where(accept, lam / 2.0, lam * 5.0))
        done_new = done | nan_step | small_step
        n_acc_new = n_acc + accept.astype(jnp.int32)
        H_norm_new = jnp.where(done, H_norm, jnp.linalg.norm(H_damped))

        return (Ts_new, lam_new, prev_E_new, H_norm_new, n_acc_new, done_new), None

    carry0 = (
        T0s,
        jnp.asarray(lambda0, dtype),
        init_E,
        jnp.asarray(0.0, dtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
    )
    (Ts, lam, _, H_norm, n_acc, done), _ = jax.lax.scan(
        step, carry0, None, length=max_iters
    )
    final_E, _ = energy(Ts)
    return LMResult(
        T0s=Ts,
        r_norm=final_E,
        H_norm=H_norm,
        lam=lam,
        n_accepted=n_acc,
        converged=done,
    )


def solve_batched(
    T0s: jnp.ndarray,
    reps: jnp.ndarray,
    p: jnp.ndarray,
    p_t: jnp.ndarray,
    wreps: jnp.ndarray | None = None,
    pmask: jnp.ndarray | None = None,
    **kwargs,
) -> LMResult:
    """vmap of :func:`solve` over a leading window/batch axis.

    ``reps`` is shared (static window structure); pose inits, points, weights
    and masks carry the batch axis. This is the unit of data parallelism for
    windowed BA: shard the batch axis over a device mesh.
    """
    in_axes = (0, None, 0, 0, 0 if wreps is not None else None,
               0 if pmask is not None else None)
    fn = lambda T, rp, pp, pt, w, pm: solve(T, rp, pp, pt, w, pm, **kwargs)
    return jax.vmap(fn, in_axes=in_axes)(T0s, reps, p, p_t, wreps, pmask)
