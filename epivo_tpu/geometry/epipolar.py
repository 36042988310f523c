"""Epipolar-depth residuals: the optimization core's math, batched.

This is the reimplementation of the reference's landmark-free
reprojection residual and its analytic SE(3) Jacobian:

- residual ``res()``            -> :func:`residual`       (ref `jac_Rt_gen_.cpp:212-259`)
- Jacobian ``Dr_Deps()``        -> :func:`residual_jacobian` (ref `jac_Rt_gen_.cpp:23-209`)
- closed-form depth             -> :func:`epipolar_depth`  (ref `kitti_E.cpp:245-250`)
- triangulation                 -> :func:`triangulate`     (ref `kitti.cpp:135-154`)

The parametrization (from the dissertation): for a match (p, p') in
normalized homogeneous coordinates and a relative pose (R, t) mapping the
source camera frame into the target frame, the source-depth of the landmark
has the closed form

    d = ||P' t|| / ||P' R p||,    P' = [[1, 0, -x'], [0, 1, -y']]

(because X' = R (d p) + t must project exactly onto p' in the ideal case).
The residual is the Huber-robustified half-squared reprojection error of
X' = R (d p) + t against p'.

Design notes:
- All functions are shape-static and mask-friendly: invalid points
  contribute exactly zero residual and zero Jacobian, mirroring the
  reference's degenerate-case `continue`s (`jac_Rt_gen_.cpp:152-154,187-189`)
  but branch-free.
- The Jacobian is *analytic* (generator-based chain rule identical in math
  to the reference) but expressed as one fused batched einsum chain instead
  of per-point heap-allocated small matrices — it is verified against
  ``jax.jacfwd`` in tests, a cross-check the reference never had (its sign
  history at `jac_Rt_gen_backup.cpp:106-141` shows why that matters).
- Unlike the reference, the Huber derivative is the exact derivative of the
  implemented residual (the reference's branch thresholds disagree by a
  factor of 2 between `res` at :255 and `Dr_Deps` at :203 — a latent
  inconsistency we do not reproduce).
"""

from __future__ import annotations

import jax.numpy as jnp

from epivo_tpu.geometry import se3

# Reference uses 1e-5 in the library (`jac_Rt_gen_.cpp:17`) and 1.0 in the
# synthetic test (`test_jac_Rt_gen.cpp:16`); both regimes are supported via
# the `huber_delta` argument.
DEFAULT_HUBER_DELTA = 1e-5
_SAFE_EPS = 1e-12


def pbar(p_t: jnp.ndarray) -> jnp.ndarray:
    """Build P' = [[1,0,-x'],[0,1,-y']] for target points [..., 3] -> [..., 2, 3]."""
    x, y = p_t[..., 0], p_t[..., 1]
    one = jnp.ones_like(x)
    zero = jnp.zeros_like(x)
    row0 = jnp.stack([one, zero, -x], axis=-1)
    row1 = jnp.stack([zero, one, -y], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def epipolar_depth(R: jnp.ndarray, t: jnp.ndarray, p: jnp.ndarray, p_t: jnp.ndarray):
    """Closed-form source depth d = ||P' t|| / ||P' R p||.

    Args:
      R: [..., 3, 3] relative rotation (source -> target).
      t: [..., 3] relative translation.
      p: [..., N, 3] source points (normalized homogeneous).
      p_t: [..., N, 3] target points.

    Returns:
      (d, valid): d [..., N] depths (0 where degenerate), valid [..., N] bool.
    """
    P = pbar(p_t)  # [..., N, 2, 3]
    A = jnp.einsum("...nij,...j->...ni", P, t)  # [..., N, 2]
    Rp = jnp.einsum("...ij,...nj->...ni", R, p)  # [..., N, 3]
    B = jnp.einsum("...nij,...nj->...ni", P, Rp)  # [..., N, 2]
    nA = jnp.linalg.norm(A, axis=-1)
    nB = jnp.linalg.norm(B, axis=-1)
    valid = nB > _SAFE_EPS
    d = jnp.where(valid, nA / jnp.where(valid, nB, 1.0), 0.0)
    return d, valid


def huber(s: jnp.ndarray, delta: float) -> jnp.ndarray:
    """The reference's robustifier on the half-squared error s = ||e||^2 / 2.

    rho(s) = s                          if s <= delta
           = delta * (sqrt(s) - delta/2) otherwise
    (ref `jac_Rt_gen_.cpp:254-257`).
    """
    safe_s = jnp.maximum(s, _SAFE_EPS)
    return jnp.where(s <= delta, s, delta * (jnp.sqrt(safe_s) - delta / 2.0))


def huber_deriv(s: jnp.ndarray, delta: float) -> jnp.ndarray:
    """Exact d rho / d s of :func:`huber`."""
    safe_s = jnp.maximum(s, _SAFE_EPS)
    return jnp.where(s <= delta, jnp.ones_like(s), delta / (2.0 * jnp.sqrt(safe_s)))


def residual(
    R: jnp.ndarray,
    t: jnp.ndarray,
    p: jnp.ndarray,
    p_t: jnp.ndarray,
    huber_delta: float = DEFAULT_HUBER_DELTA,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Per-point robust reprojection residual (ref ``res``, `jac_Rt_gen_.cpp:212-259`).

    Args:
      R, t: relative pose (source -> target), [..., 3, 3] / [..., 3].
      p, p_t: matched points [..., N, 3] normalized homogeneous.
      mask: optional [..., N] validity; invalid points give residual 0.

    Returns:
      r: [..., N] residuals.
    """
    d, valid = epipolar_depth(R, t, p, p_t)
    X = p * d[..., None]  # [..., N, 3]
    X_t = jnp.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    z = X_t[..., 2]
    z_valid = jnp.abs(z) > _SAFE_EPS
    safe_z = jnp.where(z_valid, z, 1.0)
    proj = X_t / safe_z[..., None]
    diff = proj - p_t
    s = 0.5 * jnp.sum(diff * diff, axis=-1)
    r = huber(s, huber_delta)
    ok = valid & z_valid
    if mask is not None:
        ok = ok & mask
    return jnp.where(ok, r, 0.0)


def residual_jacobian(
    Tl: jnp.ndarray,
    Tr: jnp.ndarray,
    p: jnp.ndarray,
    p_t: jnp.ndarray,
    reverse,
    huber_delta: float = DEFAULT_HUBER_DELTA,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Analytic Jacobian of :func:`residual` w.r.t. a pose-chain perturbation.

    The composed pose is ``T(eps) = Tl @ expm(sign * eps) @ Tr`` evaluated at
    ``eps = 0`` with ``sign = -1`` when ``reverse`` (the zeta appears inverted
    in the chain, ref `jac_Rt_gen_.cpp:107,127,142,171`).

    Args:
      Tl, Tr: [..., 4, 4] left/right composed transforms around the zeta.
      p, p_t: [..., N, 3] matched points.
      reverse: bool or boolean array broadcastable to the batch shape.
      mask: optional [..., N] point validity.

    Returns:
      J: [..., N, 6] rows d r_i / d eps (eps order: translation, rotation).
    """
    dtype = Tl.dtype
    G = se3.generators(dtype)  # [6, 4, 4]
    rev = jnp.asarray(reverse)
    sign = jnp.where(rev, -1.0, 1.0).astype(dtype)

    # mul44, not @: tiny batched dots under nested vmap + scan (see
    # se3.mul44).
    T0 = se3.mul44(Tl, Tr)
    R0 = T0[..., :3, :3]
    t0 = T0[..., :3, 3]

    # dT_k = sign * Tl @ G_k @ Tr  -> [..., 6, 4, 4]
    dT = sign[..., None, None, None] * jnp.einsum(
        "...ij,kjl,...lm->...kim", Tl, G, Tr
    )
    dR = dT[..., :3, :3]  # [..., 6, 3, 3]
    dt = dT[..., :3, 3]  # [..., 6, 3]

    P = pbar(p_t)  # [..., N, 2, 3]
    A = jnp.einsum("...nij,...j->...ni", P, t0)  # [..., N, 2]
    Rp = jnp.einsum("...ij,...nj->...ni", R0, p)  # [..., N, 3]
    B = jnp.einsum("...nij,...nj->...ni", P, Rp)  # [..., N, 2]

    # J_A[n, i, k] = (P_n dt_k)_i ;  J_B[n, i, k] = (P_n dR_k p_n)_i
    J_A = jnp.einsum("...nij,...kj->...nik", P, dt)  # [..., N, 2, 6]
    dRp = jnp.einsum("...kij,...nj->...nki", dR, p)  # [..., N, 6, 3]
    J_B = jnp.einsum("...nij,...nkj->...nik", P, dRp)  # [..., N, 2, 6]

    ATA = jnp.sum(A * A, axis=-1)  # [..., N]
    BTB = jnp.sum(B * B, axis=-1)
    ok = (ATA > _SAFE_EPS) & (BTB > _SAFE_EPS)
    safe_ATA = jnp.where(ok, ATA, 1.0)
    safe_BTB = jnp.where(ok, BTB, 1.0)
    nA = jnp.sqrt(safe_ATA)
    nB = jnp.sqrt(safe_BTB)

    # d d/d eps = (|B|/|A| A^T J_A - |A|/|B| B^T J_B) / |B|^2
    AtJA = jnp.einsum("...ni,...nik->...nk", A, J_A)  # [..., N, 6]
    BtJB = jnp.einsum("...ni,...nik->...nk", B, J_B)
    J_d = ((nB / nA)[..., None] * AtJA - (nA / nB)[..., None] * BtJB) / safe_BTB[
        ..., None
    ]  # [..., N, 6]

    d0 = nA / nB  # [..., N]
    # Homogeneous landmark [d p; 1]
    Hpd = jnp.concatenate(
        [p * d0[..., None], jnp.ones_like(d0)[..., None]], axis=-1
    )  # [..., N, 4]

    # J_X = d(T [d p;1])/d eps restricted to the first 3 rows:
    #     = dT_k @ Hpd + T0 @ [p;0] * J_d
    term1 = jnp.einsum("...kij,...nj->...nik", dT[..., :3, :], Hpd)  # [..., N, 3, 6]
    T0p = jnp.einsum("...ij,...nj->...ni", R0, p)  # [..., N, 3] (= T0[:3,:3] p)
    term2 = T0p[..., :, None] * J_d[..., None, :]  # [..., N, 3, 6]
    J_X = term1 + term2

    # Projection chain: X0 = R0 (d p) + t0; e = X0/z - p'
    X0 = Rp * d0[..., None] + t0[..., None, :]  # [..., N, 3]
    z = X0[..., 2]
    z_ok = jnp.abs(z) > _SAFE_EPS
    safe_z = jnp.where(z_ok, z, 1.0)
    inv_z = 1.0 / safe_z
    # J_Pi rows: [1/z, 0, -x/z^2], [0, 1/z, -y/z^2], [0,0,0]
    # e has zero third component, so only the first two rows matter; fold
    # J_Pi into e^T directly: (e^T J_Pi)_j = e_x * J_Pi[0,j] + e_y * J_Pi[1,j]
    proj = X0 * inv_z[..., None]
    e = proj - p_t  # [..., N, 3] (third comp 0)
    ex, ey = e[..., 0], e[..., 1]
    eT_JPi = jnp.stack(
        [
            ex * inv_z,
            ey * inv_z,
            -(ex * proj[..., 0] + ey * proj[..., 1]) * inv_z,
        ],
        axis=-1,
    )  # [..., N, 3]

    s = 0.5 * jnp.sum(e * e, axis=-1)
    drho = huber_deriv(s, huber_delta)  # [..., N]

    J = drho[..., None] * jnp.einsum("...ni,...nik->...nk", eT_JPi, J_X)

    good = ok & z_ok
    if mask is not None:
        good = good & mask
    return jnp.where(good[..., None], J, 0.0)


def residual_from_T(
    T: jnp.ndarray,
    p: jnp.ndarray,
    p_t: jnp.ndarray,
    huber_delta: float = DEFAULT_HUBER_DELTA,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Residual taking a homogeneous 4x4 pose directly."""
    return residual(T[..., :3, :3], T[..., :3, 3], p, p_t, huber_delta, mask)


def triangulate(
    R: jnp.ndarray,
    t: jnp.ndarray,
    p: jnp.ndarray,
    p_t: jnp.ndarray,
    min_b_norm: float = 1e-2,
):
    """Two-view triangulation by closed-form depth (ref `kitti_E.cpp:239-254`).

    Returns (X, valid): X [..., N, 3] points in the *source* camera frame
    (X = d * p), valid where the denominator ||P' R p|| exceeds
    ``min_b_norm`` (the reference's 1e-2 gate at `kitti_E.cpp:248`).
    """
    P = pbar(p_t)
    A = jnp.einsum("...nij,...j->...ni", P, t)
    Rp = jnp.einsum("...ij,...nj->...ni", R, p)
    B = jnp.einsum("...nij,...nj->...ni", P, Rp)
    nB = jnp.linalg.norm(B, axis=-1)
    valid = nB > min_b_norm
    d = jnp.where(valid, jnp.linalg.norm(A, axis=-1) / jnp.where(valid, nB, 1.0), 0.0)
    return p * d[..., None], valid
