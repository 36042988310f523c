"""Essential-matrix estimation and pose recovery, batched.

Replacement for the reference's OpenCV calls:
- ``findEssentialMat`` (RANSAC / LMedS policies, ref sites listed in
  SURVEY.md C13, e.g. `kitti_E.cpp:98-104`, `kitti_ba.cpp:232,308,702`)
  -> :mod:`epivo_tpu.ransac` drives the batched solvers here.
- ``recoverPose`` + cheirality masking (`kitti_E.cpp:120,174-186`)
  -> :func:`decompose` + :func:`recover_pose`.

Design choice: hypotheses are solved with the normalized 8-point
algorithm batched over thousands of minimal samples via one ``vmap``-ed
SVD, instead of OpenCV's serial Nistér 5-point. The 5-point action-matrix
method needs a nonsymmetric eigendecomposition; 8-point minimal samples +
Sampson scoring + the downstream LM pose refinement reaches the same
accuracy on VO-scale match counts with dense batched linear algebra
(``fivepoint`` holds a batched 5-point solver as well).

All points are in *normalized* camera coordinates (homogeneous, z=1), i.e.
already multiplied by K^-1 — matching the reference's convention after
`kitti_E.cpp:181-182`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from epivo_tpu.geometry import se3

_EPS = 1e-12


def design_rows(p: jnp.ndarray, p_t: jnp.ndarray) -> jnp.ndarray:
    """Epipolar constraint rows: p_t^T E p = A @ vec(E) (row-major vec).

    p, p_t: [..., N, 3] -> [..., N, 9].
    """
    # row = [x' x, x' y, x', y' x, y' y, y', x, y, 1]
    return (p_t[..., :, None] * p[..., None, :]).reshape(p.shape[:-1] + (9,))


def smallest_eigvec_9(AtA: jnp.ndarray, iters: int = 8) -> jnp.ndarray:
    """Eigenvector of the smallest eigenvalue of a batched PSD 9x9 matrix
    via fixed-iteration inverse iteration (batched Cholesky solves).

    Used in place of ``jnp.linalg.eigh`` for the RANSAC workload
    (thousands of tiny matrices): the full spectrum is never needed, only
    the null-ish direction, and inverse iteration converges in a handful of
    triangular solves with ratio lambda_min/lambda_2.
    """
    dtype = AtA.dtype
    tr = jnp.trace(AtA, axis1=-2, axis2=-1)[..., None, None]
    # Ridge keeps the factorization well-posed; for minimal 8-point samples
    # AtA is exactly rank-8, so the shift dominates only the null direction.
    M = AtA + 1e-7 * tr * jnp.eye(9, dtype=dtype)
    # Materialize M^-1 once; the power iterations are then pure batched
    # matvecs (the 9x9 inverse is safe here: the ridge bounds the
    # condition number). The factorization is the unrolled small-SPD
    # Cholesky (see optim/smallchol.py).
    from epivo_tpu.optim import smallchol

    Minv = smallchol.inv_spd_small(M)
    # Fixed start vector; the probability of orthogonality to the null
    # space for real data is zero (and scoring rejects any failure).
    v = jnp.ones(AtA.shape[:-2] + (9,), dtype) / 3.0
    for _ in range(iters):
        v = jnp.einsum("...ij,...j->...i", Minv, v)
        v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v


def project_essential(E: jnp.ndarray) -> jnp.ndarray:
    """Project to the essential manifold: singular values (1, 1, 0), with
    det(U) = det(V) = +1 so decompose() yields proper rotations.

    Uses the closed-form batched 3x3 SVD (``linalg3.svd3`` — already
    proper-rotation U/V): thousands of RANSAC hypotheses per call made
    ``jnp.linalg.svd``'s per-matrix Jacobi iteration the pipeline hot spot.
    """
    from epivo_tpu.geometry import linalg3

    U, _, Vt = linalg3.svd3(E)
    # E' = u0 v0^T + u1 v1^T (singular values pinned to (1, 1, 0)).
    return (
        U[..., :, 0:1] @ Vt[..., 0:1, :] + U[..., :, 1:2] @ Vt[..., 1:2, :]
    )


def eight_point(p: jnp.ndarray, p_t: jnp.ndarray,
                weights: jnp.ndarray | None = None,
                project: bool = True) -> jnp.ndarray:
    """(Weighted) 8-point essential estimate.

    p, p_t: [..., N, 3] with N >= 8. Returns E [..., 3, 3], projected to
    singular values (1, 1, 0) when ``project`` (skip for RANSAC hypothesis
    scoring — Sampson error doesn't need the manifold projection, and
    dropping thousands of tiny SVDs is a large win; the winning hypothesis
    is projected at refit). Accepts row weights (e.g. an inlier mask) for
    masked refits with static shapes.
    """
    A = design_rows(p, p_t)  # [..., N, 9]
    if weights is not None:
        A = A * weights[..., None]
    # Smallest right singular vector of A == eigenvector of A^T A for the
    # smallest eigenvalue; the 9x9 normal matrix keeps the solve size
    # independent of N.
    AtA = jnp.einsum("...ni,...nj->...ij", A, A)
    e = smallest_eigvec_9(AtA)
    E = e.reshape(e.shape[:-1] + (3, 3))
    if project:
        E = project_essential(E)
    return E


def sampson_error(E: jnp.ndarray, p: jnp.ndarray, p_t: jnp.ndarray) -> jnp.ndarray:
    """First-order geometric (Sampson) error of the epipolar constraint.

    E: [..., 3, 3]; p, p_t: [..., N, 3]. Returns [..., N] squared errors in
    normalized-coordinate units.
    """
    Ep = jnp.einsum("...ij,...nj->...ni", E, p)  # [..., N, 3]
    Etp = jnp.einsum("...ji,...nj->...ni", E, p_t)
    num = jnp.einsum("...ni,...ni->...n", p_t, Ep)  # p_t^T E p
    den = (
        Ep[..., 0] ** 2 + Ep[..., 1] ** 2 + Etp[..., 0] ** 2 + Etp[..., 1] ** 2
    )
    return num * num / jnp.maximum(den, _EPS)


def decompose(E: jnp.ndarray):
    """E -> four (R, t) candidates: [..., 4, 3, 3], [..., 4, 3].

    Standard SVD factorization E = U diag(1,1,0) V^T; R in {U W V^T, U W^T V^T},
    t = +-u3 (unit norm, matching OpenCV's recoverPose convention the
    reference relies on, `kitti_E.cpp:120`). Closed-form batched SVD
    (proper rotations by construction) — see :func:`project_essential`.
    """
    from epivo_tpu.geometry import linalg3

    U, _, Vt = linalg3.svd3(E)
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]
    Rs = jnp.stack([Ra, Ra, Rb, Rb], axis=-3)  # [..., 4, 3, 3]
    ts = jnp.stack([t, -t, t, -t], axis=-2)  # [..., 4, 3]
    return Rs, ts


def _depths_two_view(R, t, p, p_t):
    """Closed-form depths in both frames for cheirality checks.

    Triangulates by the midpoint-free epipolar depth (same formula as the
    optimizer core): d = ||P' t|| / ||P' R p||; target depth is the z of
    R (d p) + t. Returns (d_src [..., N], d_tgt [..., N]).

    The sign of d is recovered from the projection consistency: the formula
    yields |d|; a negative-depth configuration shows up as the reprojection
    landing on the antipode, detected via dot(P' R p, -P' t) orientation.
    """
    x, y = p_t[..., 0], p_t[..., 1]
    one = jnp.ones_like(x)
    zero = jnp.zeros_like(x)
    P0 = jnp.stack([one, zero, -x], axis=-1)
    P1 = jnp.stack([zero, one, -y], axis=-1)
    Rp = jnp.einsum("...ij,...nj->...ni", R, p)
    A0 = jnp.einsum("...ni,...i->...n", P0, t)
    A1 = jnp.einsum("...ni,...i->...n", P1, t)
    B0 = jnp.einsum("...ni,...ni->...n", P0, Rp)
    B1 = jnp.einsum("...ni,...ni->...n", P1, Rp)
    # Signed least-squares depth: P'(R p d + t) = 0 => d = -(B . A)/(B . B)
    # (2D dot over the two P' rows). This keeps the *sign* of d, which the
    # norm-ratio form discards.
    BdotA = B0 * A0 + B1 * A1
    BdotB = B0 * B0 + B1 * B1
    d_src = -BdotA / jnp.maximum(BdotB, _EPS)
    X_t = Rp * d_src[..., None] + t[..., None, :]
    return d_src, X_t[..., 2]


def recover_pose(E: jnp.ndarray, p: jnp.ndarray, p_t: jnp.ndarray,
                 mask: jnp.ndarray | None = None):
    """Cheirality-checked pose recovery (ref ``recoverPose``, C14).

    Args:
      E: [3, 3] (or batched [..., 3, 3]) essential matrix.
      p, p_t: [..., N, 3] normalized matches.
      mask: optional [..., N] inlier mask — only these points vote.

    Returns:
      (R [..., 3, 3], t [..., 3], front [..., N] bool): the candidate with the
      most points in front of both cameras, and the per-point cheirality mask
      for that candidate (the reference's `mask==255` filter,
      `kitti_E.cpp:174-186`).
    """
    Rs, ts = decompose(E)  # [..., 4, 3, 3], [..., 4, 3]
    d_src, d_tgt = _depths_two_view(
        Rs, ts, p[..., None, :, :], p_t[..., None, :, :]
    )  # [..., 4, N]
    front = (d_src > 0) & (d_tgt > 0)
    votes = front
    if mask is not None:
        votes = votes & mask[..., None, :]
    counts = jnp.sum(votes, axis=-1)  # [..., 4]
    best = jnp.argmax(counts, axis=-1)
    R = jnp.take_along_axis(Rs, best[..., None, None, None], axis=-3).squeeze(-3)
    t = jnp.take_along_axis(ts, best[..., None, None], axis=-2).squeeze(-2)
    front_best = jnp.take_along_axis(front, best[..., None, None], axis=-2).squeeze(-2)
    return R, t, front_best


def refine_essential(
    E: jnp.ndarray,
    p: jnp.ndarray,
    p_t: jnp.ndarray,
    mask: jnp.ndarray | None = None,
    iters: int = 8,
    damping: float = 1e-6,
) -> jnp.ndarray:
    """Gauss-Newton refinement of E on its 5-DoF manifold (Sampson cost).

    The accuracy counterpart of OpenCV's 5-point solver without the
    nonsymmetric eigenproblem: parametrize E = [t]_x R by a
    rotation increment (3 DoF) and a translation-direction increment in the
    tangent plane of the unit sphere (2 DoF), and iterate damped GN on the
    Sampson residuals. Fixed iteration count, jit/vmap-safe.
    """
    from epivo_tpu.geometry import se3 as _se3

    m = mask if mask is not None else jnp.ones(p.shape[:-1], bool)
    mf = m.astype(E.dtype)

    # Initial (R, t) from E via cheirality vote.
    R0, t0, _ = recover_pose(E, p, p_t, mask=m)

    def sampson_vec(R, t):
        Ecur = _se3.hat(t) @ R
        # Signed first-order residual (not squared) for GN.
        Ep = jnp.einsum("ij,nj->ni", Ecur, p)
        Etp = jnp.einsum("ji,nj->ni", Ecur, p_t)
        num = jnp.einsum("ni,ni->n", p_t, Ep)
        den = jnp.sqrt(
            Ep[..., 0] ** 2 + Ep[..., 1] ** 2
            + Etp[..., 0] ** 2 + Etp[..., 1] ** 2 + _EPS
        )
        return (num / den) * mf

    def basis(t):
        # Two unit vectors spanning the tangent plane at t on S^2.
        a = jnp.where(jnp.abs(t[0]) < 0.9,
                      jnp.array([1.0, 0.0, 0.0], t.dtype),
                      jnp.array([0.0, 1.0, 0.0], t.dtype))
        b1 = jnp.cross(t, a)
        b1 = b1 / (jnp.linalg.norm(b1) + _EPS)
        b2 = jnp.cross(t, b1)
        return b1, b2

    def step(carry, _):
        R, t = carry

        def res_of(delta):
            dR = _se3.so3_exp(delta[:3])
            b1, b2 = basis(t)
            dt = _se3.so3_exp(b1 * delta[3] + b2 * delta[4])
            return sampson_vec(R @ dR, dt @ t)

        r0 = res_of(jnp.zeros(5, E.dtype))
        J = jax.jacfwd(res_of)(jnp.zeros(5, E.dtype))  # [N, 5]
        H = J.T @ J + damping * jnp.eye(5, dtype=E.dtype)
        from epivo_tpu.optim import smallchol

        delta = -smallchol.solve_spd_small(H, J.T @ r0)
        r1 = res_of(delta)
        accept = jnp.sum(r1 * r1) < jnp.sum(r0 * r0)
        delta = jnp.where(accept, delta, jnp.zeros_like(delta))
        dR = _se3.so3_exp(delta[:3])
        b1, b2 = basis(t)
        dt = _se3.so3_exp(b1 * delta[3] + b2 * delta[4])
        return (R @ dR, dt @ t), None

    (R, t), _ = jax.lax.scan(step, (R0, t0), None, length=iters)
    E_new = _se3.hat(t) @ R
    return E_new / (jnp.linalg.norm(E_new) + _EPS)


def pose_fallback(R: jnp.ndarray, t: jnp.ndarray,
                  fallback_t=(0.1, 0.1, -0.9),
                  trace_min: float = 2.7,
                  t_norm_min: float = 1e-5):
    """Degenerate-pose guards (ref C15, `kitti_E.cpp:128-135`):
    near-degenerate rotation -> identity + canned translation; vanishing
    translation -> canned translation. Branch-free."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    bad_R = tr < trace_min
    canned = jnp.asarray(fallback_t, R.dtype)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    R_out = jnp.where(bad_R[..., None, None], eye, R)
    t_out = jnp.where(bad_R[..., None], jnp.broadcast_to(canned, t.shape), t)
    bad_t = jnp.linalg.norm(t_out, axis=-1) < t_norm_min
    t_out = jnp.where(bad_t[..., None], jnp.broadcast_to(canned, t.shape), t_out)
    return R_out, t_out
