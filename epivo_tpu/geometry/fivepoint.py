"""Batched Nistér/Stewénius 5-point essential-matrix solver.

The reference's E estimation goes through OpenCV's ``findEssentialMat``,
whose minimal solver is Nistér's 5-point (`kitti_E.cpp:98-104`). Round 1-2
substituted batched 8-point + manifold refinement (cv2-accuracy-class,
A/B-tested) to avoid a nonsymmetric eigensolver; this module
closes the remaining gap — a TRUE minimal solver, so RANSAC needs only 5
inliers per sample (vs 8), which matters at high outlier ratios.

Design (everything batched over S samples, fixed shapes):

1. Nullspace: the 4-dim nullspace of the 5x9 constraint matrix via
   subspace inverse iteration on the ridge-shifted 9x9 normal matrix
   (batched Cholesky solves + Gram-Schmidt) — no SVD.
2. Polynomial system: E = x X + y Y + z Z + W. The 10 cubic constraints
   (det E = 0 and 2 E E^T E - tr(E E^T) E = 0) expand over the 20
   monomials of degree <= 3 in (x, y, z) with *static* exponent
   bookkeeping (Python dicts of monomial -> [S] coefficient arrays).
3. Stewenius reduction: Gauss-Jordan with virtual partial pivoting over
   the 10 degree-3 monomial columns yields the quotient-ring reduction
   C, from which the 10x10 action matrix of multiplication-by-x in the
   degree-<=2 monomial basis is assembled.
4. Real eigenvalues WITHOUT a nonsymmetric eig: the action matrix is
   Gershgorin-scaled to put its spectrum in [-1, 1], its characteristic
   polynomial is built by the Faddeev-LeVerrier recurrence (10 batched
   10x10 matmuls), and real roots are isolated by sign changes on a
   static grid + fixed-iteration bisection — branch-free, all lanes.
5. Eigenvectors by inverse iteration (batched Gauss-Jordan solves); the
   basis vector is [x^2, xy, y^2, xz, yz, z^2, x, y, z, 1] evaluated at
   the solution, so (x, y, z) read off its tail.

Up to 10 candidate E per sample with a validity mask; RANSAC scores all
of them (``ransac.ransac_essential(solver="5pt")``).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from epivo_tpu.geometry import essential

# Monomial orders (exponent triples over x, y, z).
_B = [(2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1), (0, 0, 2),
      (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]  # degree <= 2 basis
_D3 = [(3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0), (2, 0, 1), (1, 1, 1),
       (0, 2, 1), (1, 0, 2), (0, 1, 2), (0, 0, 3)]  # degree-3 monomials
_COLS = {m: i for i, m in enumerate(_D3 + _B)}  # 20 columns, [D3 | B]
_BIDX = {m: i for i, m in enumerate(_B)}
_D3IDX = {m: i for i, m in enumerate(_D3)}

# Sign-change probes over the eigenvalue range. Real-root PAIRS closer
# than one grid cell are invisible to sign counting (they appear near the
# complex->real transition), so resolution directly sets the per-sample
# solution recall; 512 log-spaced probes resolve pairs ~1.8% apart.
_GRID = 512
_BISECT = 36


def _pmul(a: dict, b: dict) -> dict:
    out: dict = {}
    for ma, ca in a.items():
        for mb, cb in b.items():
            m = (ma[0] + mb[0], ma[1] + mb[1], ma[2] + mb[2])
            c = ca * cb
            out[m] = out[m] + c if m in out else c
    return out


def _padd(a: dict, b: dict, scale=1.0) -> dict:
    out = dict(a)
    for m, c in b.items():
        cc = c * scale
        out[m] = out[m] + cc if m in out else cc
    return out


def nullspace4(p: jnp.ndarray, p_t: jnp.ndarray, iters: int = 6):
    """4 orthonormal null vectors of the [S, 5, 9] constraint matrix.

    Subspace inverse iteration on AtA + ridge (rank <= 5, so the 4 zero
    eigenvalues are exact; convergence ratio is ridge/lambda_5).
    Returns [S, 4, 3, 3] (basis matrices X, Y, Z, W).
    """
    A = essential.design_rows(p, p_t)  # [S, 5, 9]
    AtA = jnp.einsum("...ni,...nj->...ij", A, A)
    dtype = AtA.dtype
    tr = jnp.trace(AtA, axis1=-2, axis2=-1)[..., None, None]
    M = AtA + 1e-6 * (tr + 1e-30) * jnp.eye(9, dtype=dtype)
    L = jnp.linalg.cholesky(M)
    Minv = jax.scipy.linalg.cho_solve(
        (L, True), jnp.broadcast_to(jnp.eye(9, dtype=dtype), M.shape))
    # Fixed start block; deterministic, generic.
    rng = np.random.default_rng(12345)
    V0 = jnp.asarray(rng.normal(size=(9, 4)).astype(np.float32), dtype)
    V = jnp.broadcast_to(V0, AtA.shape[:-2] + (9, 4))
    for _ in range(iters):
        V = jnp.einsum("...ij,...jk->...ik", Minv, V)
        # Modified Gram-Schmidt over the 4 columns (unrolled).
        cols = []
        for c in range(4):
            v = V[..., :, c]
            for u in cols:
                v = v - jnp.sum(v * u, axis=-1, keepdims=True) * u
            v = v / (jnp.linalg.norm(v, axis=-1, keepdims=True) + 1e-30)
            cols.append(v)
        V = jnp.stack(cols, axis=-1)
    basis = jnp.moveaxis(V, -1, -2)  # [S, 4, 9]
    return basis.reshape(basis.shape[:-1] + (3, 3))


def _constraint_matrix(basis: jnp.ndarray) -> jnp.ndarray:
    """[S, 10, 20] cubic-constraint coefficients over [_D3 | _B] monomials.

    basis: [S, 4, 3, 3] nullspace matrices (X, Y, Z, W); E = x X + y Y
    + z Z + W.
    """
    S = basis.shape[0]
    xyz1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
    Ep = [[{xyz1[k]: basis[:, k, i, j] for k in range(4)}
           for j in range(3)] for i in range(3)]

    rows = []
    # det(E) = 0
    det = {}
    for (i0, i1, i2), sgn in ((((0, 1, 2)), 1.0), ((0, 2, 1), -1.0),
                              ((1, 0, 2), -1.0), ((1, 2, 0), 1.0),
                              ((2, 0, 1), 1.0), ((2, 1, 0), -1.0)):
        det = _padd(det, _pmul(_pmul(Ep[0][i0], Ep[1][i1]), Ep[2][i2]), sgn)
    rows.append(det)

    # 2 E E^T E - tr(E E^T) E = 0 (9 equations)
    EEt = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            acc = {}
            for k in range(3):
                acc = _padd(acc, _pmul(Ep[i][k], Ep[j][k]))
            EEt[i][j] = acc
    trace = _padd(_padd(EEt[0][0], EEt[1][1]), EEt[2][2])
    for i in range(3):
        for j in range(3):
            acc = {}
            for k in range(3):
                acc = _padd(acc, _pmul(EEt[i][k], Ep[k][j]))
            g = _padd({m: 2.0 * c for m, c in acc.items()},
                      _pmul(trace, Ep[i][j]), -1.0)
            rows.append(g)

    M = jnp.zeros((S, 10, 20), basis.dtype)
    for r, poly in enumerate(rows):
        for m, c in poly.items():
            M = M.at[:, r, _COLS[m]].set(c)
    return M


def _gauss_jordan_reduce(M: jnp.ndarray):
    """Reduce [S, 10, 20] over the first 10 columns (virtual partial
    pivoting). Returns (C [S, 10, 10], ok [S]) with row k of C holding the
    degree-<=2 tail of the reduction of degree-3 monomial k:
    D3[k] = -sum_j C[k, j] * B[j] modulo the ideal."""
    S = M.shape[0]
    used = jnp.zeros((S, 10), bool)
    ok = jnp.ones((S,), bool)
    piv_rows = []
    for k in range(10):
        col = jnp.where(used, -1.0, jnp.abs(M[:, :, k]))
        r = jnp.argmax(col, axis=1)  # [S]
        pval = jnp.take_along_axis(M[:, :, k], r[:, None], 1)[:, 0]
        good = jnp.abs(pval) > 1e-12
        ok = ok & good
        prow = jnp.take_along_axis(M, r[:, None, None], 1)[:, 0]  # [S, 20]
        prow = prow / jnp.where(good, pval, 1.0)[:, None]
        is_piv = jnp.arange(10)[None, :] == r[:, None]
        factor = jnp.where(is_piv, 0.0, M[:, :, k])
        M = M - factor[:, :, None] * prow[:, None, :]
        M = jnp.where(is_piv[:, :, None], prow[:, None, :], M)
        used = used | is_piv
        piv_rows.append(r)
    pr = jnp.stack(piv_rows, axis=1)  # [S, 10] row of pivot for column k
    C = jnp.take_along_axis(M[:, :, 10:], pr[:, :, None], 1)
    return C, ok


def _action_matrix_x(C: jnp.ndarray) -> jnp.ndarray:
    """Multiplication-by-x action matrix [S, 10, 10] in the _B basis."""
    S = C.shape[0]
    A = jnp.zeros((S, 10, 10), C.dtype)
    for i, b in enumerate(_B):
        m = (b[0] + 1, b[1], b[2])
        if m in _BIDX:
            A = A.at[:, i, _BIDX[m]].set(1.0)
        else:
            A = A.at[:, i, :].set(-C[:, _D3IDX[m], :])
    return A


def _balance(A: jnp.ndarray, sweeps: int = 3) -> jnp.ndarray:
    """Diagonal-similarity balancing (eigenvalues preserved).

    The raw action matrix can have row sums ~20x its spectral radius;
    Gershgorin-scaling by that crams the spectrum near 0 where the f32
    characteristic polynomial loses sign fidelity. Two or three balancing
    sweeps (powers-of-2 row/col norm equalization, batched) tighten the
    bound to within a small factor of the spectral radius.

    Returns (A_balanced, d) with A_b = D^-1 A D, D = diag(d): eigenvalues
    unchanged, eigenvectors v = D v_b.
    """
    n = A.shape[-1]
    d = jnp.ones(A.shape[:-2] + (n,), A.dtype)
    for _ in range(sweeps):
        for i in range(n):
            r = jnp.sum(jnp.abs(A[..., i, :]), axis=-1) - jnp.abs(
                A[..., i, i])
            c = jnp.sum(jnp.abs(A[..., :, i]), axis=-1) - jnp.abs(
                A[..., i, i])
            safe = (r > 1e-30) & (c > 1e-30)
            # row i scales by 1/f, col i by f: equal norms at f = sqrt(r/c).
            f = jnp.sqrt(jnp.where(safe, r / jnp.where(safe, c, 1.0), 1.0))
            f = jnp.exp2(jnp.round(jnp.log2(jnp.maximum(f, 1e-30))))
            f = jnp.clip(f, 2.0**-8, 2.0**8)
            # row i /= f, col i *= f  == (D^-1 A D) with d_i *= f
            A = A.at[..., i, :].multiply(1.0 / f[..., None])
            A = A.at[..., :, i].multiply(f[..., None])
            d = d.at[..., i].multiply(f)
    return A, d


def _det10(A: jnp.ndarray) -> jnp.ndarray:
    """Signed determinant of batched [.., 10, 10] via Gauss elimination
    with virtual partial pivoting (product of pivots x permutation
    parity). Evaluating det(A - lambda I) directly is numerically far
    better conditioned in f32 than any explicit characteristic
    polynomial (whose monomial coefficients span ~15 orders here)."""
    batch = A.shape[:-2]
    M = A.reshape((-1, 10, 10))
    S = M.shape[0]
    used = jnp.zeros((S, 10), bool)
    det = jnp.ones((S,), A.dtype)
    piv_rows = []
    for k in range(10):
        col = jnp.where(used, -1.0, jnp.abs(M[:, :, k]))
        r = jnp.argmax(col, axis=1)
        pval = jnp.take_along_axis(M[:, :, k], r[:, None], 1)[:, 0]
        det = det * pval
        prow = jnp.take_along_axis(M, r[:, None, None], 1)[:, 0]
        prow = prow / jnp.where(jnp.abs(pval) > 1e-38, pval, 1.0)[:, None]
        is_piv = jnp.arange(10)[None, :] == r[:, None]
        factor = jnp.where(is_piv | used, 0.0, M[:, :, k])
        M = M - factor[:, :, None] * prow[:, None, :]
        used = used | is_piv
        piv_rows.append(r)
    pr = jnp.stack(piv_rows, axis=1)  # [S, 10]
    inv = jnp.sum((pr[:, :, None] > pr[:, None, :])
                  & (jnp.arange(10)[:, None] < jnp.arange(10)[None, :])[None],
                  axis=(1, 2))
    sign = jnp.where(inv % 2 == 0, 1.0, -1.0).astype(A.dtype)
    return (det * sign).reshape(batch)


def _charfn(A: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """det(A - lam I): A [S, 10, 10], lam [S, G] -> [S, G]."""
    eye = jnp.eye(10, dtype=A.dtype)
    M = A[:, None] - lam[..., None, None] * eye
    return _det10(M)


_GRID_DECADES = 4.0  # log grid spans [radius * 10^-4, radius]


def _real_roots(A: jnp.ndarray, radius: jnp.ndarray):
    """Up to 10 real eigenvalues of batched [S, 10, 10] matrices.

    Sign changes of det(A - lambda I) on a symmetric log-spaced grid
    (the spectrum can span 4 orders of magnitude: w->0 solutions push
    eigenvalues to +-100s while physical roots sit at O(1) or below),
    then fixed-iteration bisection. ``radius`` [S] bounds |eigenvalues|
    (Gershgorin after balancing).

    Returns (roots [S, 10], valid [S, 10]).
    """
    S = A.shape[0]
    dtype = A.dtype
    half = _GRID // 2  # points per sign
    expo = jnp.linspace(-_GRID_DECADES, 0.0, half, dtype=dtype)
    mag = 10.0 ** expo  # (1e-4 .. 1]
    tpl = jnp.concatenate([-mag[::-1], jnp.zeros((1,), dtype), mag])
    lam = radius[:, None] * 1.05 * tpl[None]  # [S, G+1] ascending
    vals = _charfn(A, lam)
    sign = jnp.sign(vals)
    change = (sign[:, :-1] * sign[:, 1:]) <= 0.0
    change = change & (jnp.abs(vals[:, :-1]) + jnp.abs(vals[:, 1:]) > 0.0)
    G = tpl.shape[0] - 1
    score = change.astype(dtype) * 2.0 - jnp.arange(G, dtype=dtype)[None] * 1e-6
    topv, topi = jax.lax.top_k(score, 10)  # [S, 10]
    valid = topv > 0.5
    a = jnp.take_along_axis(lam, topi, 1)
    b = jnp.take_along_axis(lam, topi + 1, 1)
    fa = _charfn(A, a)
    for _ in range(_BISECT):
        m = 0.5 * (a + b)
        fm = _charfn(A, m)
        left = fa * fm <= 0.0
        a, b = jnp.where(left, a, m), jnp.where(left, m, b)
        fa = jnp.where(left, fa, fm)
    return 0.5 * (a + b), valid


def _solve_gj(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 10x10 Gauss-Jordan solve with virtual partial pivoting.
    A [S, 10, 10], b [S, 10] -> x [S, 10] (garbage where singular; callers
    mask)."""
    M = jnp.concatenate([A, b[..., None]], axis=-1)  # [S, 10, 11]
    S = M.shape[0]
    used = jnp.zeros((S, 10), bool)
    piv_rows = []
    for k in range(10):
        col = jnp.where(used, -1.0, jnp.abs(M[:, :, k]))
        r = jnp.argmax(col, axis=1)
        pval = jnp.take_along_axis(M[:, :, k], r[:, None], 1)[:, 0]
        prow = jnp.take_along_axis(M, r[:, None, None], 1)[:, 0]
        prow = prow / jnp.where(jnp.abs(pval) > 1e-20, pval, 1.0)[:, None]
        is_piv = jnp.arange(10)[None, :] == r[:, None]
        factor = jnp.where(is_piv, 0.0, M[:, :, k])
        M = M - factor[:, :, None] * prow[:, None, :]
        M = jnp.where(is_piv[:, :, None], prow[:, None, :], M)
        used = used | is_piv
        piv_rows.append(r)
    pr = jnp.stack(piv_rows, axis=1)
    return jnp.take_along_axis(M[:, :, 10], pr, 1)


def five_point(p: jnp.ndarray, p_t: jnp.ndarray):
    """Batched 5-point minimal solver.

    p, p_t: [S, 5, 3] normalized matches. Returns (Es [S, 10, 3, 3],
    valid [S, 10]) — up to 10 essential-matrix candidates per sample.
    """
    S = p.shape[0]
    dtype = p.dtype
    basis = nullspace4(p, p_t)  # [S, 4, 3, 3]
    M = _constraint_matrix(basis)
    # Row scaling (each constraint is homogeneous): improves GJ pivots.
    M = M / (jnp.max(jnp.abs(M), axis=-1, keepdims=True) + 1e-30)
    C, ok = _gauss_jordan_reduce(M)
    Ax = _action_matrix_x(C)

    # Balancing tightens the Gershgorin radius to within a small factor of
    # the spectral radius (eigenvalues preserved).
    Axb, dbal = _balance(Ax)
    radius = jnp.max(jnp.sum(jnp.abs(Axb), axis=-1), axis=-1) + 1e-12  # [S]
    mu, root_ok = _real_roots(Axb, radius)  # [S, 10] eigenvalues (= x)

    # Eigenvectors by inverse iteration per root: solve
    # (Axb - mu I + eps) v = v0 twice (eps scale-aware).
    eyeb = jnp.eye(10, dtype=dtype)
    eps = (1e-6 * radius)[:, None, None, None]
    Ashift = (Axb[:, None] - mu[:, :, None, None] * eyeb
              + eps * eyeb)  # [S, 10, 10, 10]
    Af = Ashift.reshape(S * 10, 10, 10)
    rng = np.random.default_rng(999)
    v0 = jnp.asarray(rng.normal(size=(10,)).astype(np.float32), dtype)
    v = _solve_gj(Af, jnp.broadcast_to(v0, (S * 10, 10)))
    v = _solve_gj(Af, v / (jnp.linalg.norm(v, axis=-1, keepdims=True)
                           + 1e-30))
    v = v.reshape(S, 10, 10)
    # Undo the balancing similarity: the monomial-structured eigenvector
    # of the ORIGINAL action matrix is v = D v_balanced.
    v = v * dbal[:, None, :]

    w = v[:, :, 9]  # coefficient of the constant monomial
    w_ok = jnp.abs(w) > 1e-12
    wsafe = jnp.where(w_ok, w, 1.0)
    # x from the eigenvalue itself (more accurate than the vector ratio).
    x = mu
    y = v[:, :, 7] / wsafe
    z = v[:, :, 8] / wsafe

    Es = (x[..., None, None] * basis[:, None, 0]
          + y[..., None, None] * basis[:, None, 1]
          + z[..., None, None] * basis[:, None, 2]
          + basis[:, None, 3])  # [S, 10, 3, 3]
    n = jnp.linalg.norm(Es.reshape(S, 10, 9), axis=-1)
    n_ok = n > 1e-12
    Es = Es / jnp.where(n_ok, n, 1.0)[..., None, None]
    # Exact-manifold candidates: f32 root/eigvec error leaves det(E) at up
    # to ~1e-3; the closed-form 3x3 SVD projection pins (1, 1, 0) singular
    # values (cheap, and recover_pose expects proper essential matrices).
    # Renormalized to unit Frobenius norm afterwards.
    Es = essential.project_essential(Es) / jnp.sqrt(2.0).astype(dtype)
    valid = ok[:, None] & root_ok & w_ok & n_ok
    return Es, valid
