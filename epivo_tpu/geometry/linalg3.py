"""Closed-form batched 3x3 factorizations for the RANSAC hot path.

``jnp.linalg.svd`` runs an iterative factorization per matrix — for the
essential-matrix pipeline that is thousands of tiny dependent iterations
per RANSAC call (512 hypothesis projections + pose recovery). These
functions replace it with the analytic route:

  eigvals of the symmetric M^T M via the trigonometric (Cardano) formula,
  eigenvectors via cross-products of (A - lambda I) rows,
  U recovered by mapping V through M with an orthonormal completion.

Everything is elementwise batched math — no per-matrix iteration, no
data-dependent control flow. Accuracy is f32-sufficient for RANSAC
hypothesis projection AND for final pose recovery (validated against
OpenCV in tests/test_opencv_parity.py and against jnp.linalg.svd in
tests/test_linalg3.py).

Convention notes for the essential-matrix consumers:
- singular values are returned in descending order;
- U and V are both proper rotations (det = +1), which is exactly the
  convention `essential.decompose`/`project_essential` enforce after
  LAPACK-style SVD.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-20


def sym_eigh3_desc(A: jnp.ndarray):
    """Eigendecomposition of symmetric [..., 3, 3]: (w desc [..., 3],
    V [..., 3, 3] with eigenvectors in columns, right-handed)."""
    dtype = A.dtype
    q = jnp.trace(A, axis1=-2, axis2=-1) / 3.0
    I = jnp.eye(3, dtype=dtype)
    B = A - q[..., None, None] * I
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, _EPS))
    detB = jnp.linalg.det(B)
    r = detB / (2.0 * p**3 + _EPS)
    r = jnp.clip(r, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    w0 = q + 2.0 * p * jnp.cos(phi)
    w2 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    w1 = 3.0 * q - w0 - w2
    w = jnp.stack([w0, w1, w2], axis=-1)  # descending by construction

    def eigvec(lmbda):
        # Rows of (A - lambda I); eigenvector ⟂ all rows -> cross products.
        M = A - lmbda[..., None, None] * I
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        c01 = jnp.cross(r0, r1)
        c12 = jnp.cross(r1, r2)
        c20 = jnp.cross(r2, r0)
        n01 = jnp.sum(c01 * c01, axis=-1, keepdims=True)
        n12 = jnp.sum(c12 * c12, axis=-1, keepdims=True)
        n20 = jnp.sum(c20 * c20, axis=-1, keepdims=True)
        # Pick the largest cross product (most numerically stable).
        best12 = (n12 >= n01) & (n12 >= n20)
        best20 = (n20 >= n01) & ~best12
        v = jnp.where(best12, c12, jnp.where(best20, c20, c01))
        n = jnp.where(best12, n12, jnp.where(best20, n20, n01))
        return v / jnp.sqrt(jnp.maximum(n, _EPS))

    v0 = eigvec(w0)
    v2 = eigvec(w2)
    # Near-degenerate pairs make the cross-product eigenvector of the
    # CLUSTERED eigenvalues noise-dominated (essential matrices have
    # w0 ~= w1 by construction). Trust whichever end has the larger
    # spectral gap, and rebuild the other by orthogonalization; branchless.
    gap0 = w0 - w1
    gap2 = w1 - w2
    trust0 = (gap0 >= gap2)[..., None]

    def orth(u, against):
        u = u - jnp.sum(against * u, axis=-1, keepdims=True) * against
        return u / jnp.sqrt(
            jnp.maximum(jnp.sum(u * u, axis=-1, keepdims=True), _EPS))

    v0_f = jnp.where(trust0, v0, orth(v0, v2))
    v2_f = jnp.where(trust0, orth(v2, v0), v2)
    v1 = jnp.cross(v2_f, v0_f)
    V = jnp.stack([v0_f, v1, v2_f], axis=-1)  # columns
    return w, V


def svd3(M: jnp.ndarray):
    """Batched [..., 3, 3] SVD with U, V proper rotations.

    Returns (U [..., 3, 3], s [..., 3] descending >= 0, Vt [..., 3, 3])
    with det(U) = det(Vt) = +1 — the convention the essential-matrix code
    needs (plain SVD followed by the det-sign fixup in `essential.py`).
    The smallest singular value's sign freedom is absorbed into s being
    clamped at >= 0 with u2 = u0 x u1; for exactly rank-2 inputs
    (essential matrices) this is exact.
    """
    w, V = sym_eigh3_desc(jnp.einsum("...ji,...jk->...ik", M, M))
    s = jnp.sqrt(jnp.maximum(w, 0.0))
    # Right-handed V (sym_eigh3_desc already returns det=+1 by
    # construction: v1 = v2 x v0 makes [v0, v1, v2] right-handed).
    MV = jnp.einsum("...ij,...jk->...ik", M, V)  # columns M v_k
    u0 = MV[..., :, 0] / jnp.maximum(s[..., 0:1], _EPS)
    u1 = MV[..., :, 1] - jnp.sum(MV[..., :, 1] * u0, axis=-1, keepdims=True) * u0
    u1 = u1 / jnp.sqrt(
        jnp.maximum(jnp.sum(u1 * u1, axis=-1, keepdims=True), _EPS))
    u2 = jnp.cross(u0, u1)
    U = jnp.stack([u0, u1, u2], axis=-1)
    Vt = jnp.swapaxes(V, -1, -2)
    # det(U)=+1 by u2 = u0 x u1. det(V): v1 = v2 x v0 -> det +1. But the
    # product U diag(s) Vt must equal M: for det(M) < 0 the rank-3
    # reconstruction needs a negative smallest singular value; essential
    # consumers never need that (they zero s[2]), so we leave s >= 0 and
    # document the deviation from LAPACK (which keeps U unitary of any
    # sign pattern).
    return U, s, Vt
