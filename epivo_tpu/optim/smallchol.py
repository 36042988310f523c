"""Unrolled Cholesky for tiny SPD systems (batch-leading layout).

For static D <= ~16 the factorization unrolls into a pure elementwise op
chain over the batch dims that XLA fuses into a handful of kernels, in
place of the batched ``jnp.linalg.solve`` / ``cholesky`` loops. The lane-major variant lives in ``lm_lanes._chol_solve_lanes``;
this one keeps the conventional [..., D, D] layout for drop-in use.

The sqrt guard keeps non-SPD garbage local: NaN/garbage deltas are the
caller's to reject (LM accept gates, RANSAC scoring).
"""

from __future__ import annotations

import jax.numpy as jnp


def cholesky_small(H: jnp.ndarray):
    """Lower-triangular factor of [..., D, D] SPD H as a list-of-lists of
    [...]-shaped entries (no materialized matrix)."""
    D = H.shape[-1]
    L = [[None] * D for _ in range(D)]
    for i in range(D):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def chol_solve_small(L, b: jnp.ndarray) -> jnp.ndarray:
    """Solve L L^T x = b for b [..., D] given :func:`cholesky_small` L."""
    D = len(L)
    y = [None] * D
    for i in range(D):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * D
    for i in range(D - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, D):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def solve_spd_small(H: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """x = H^-1 b for tiny SPD H [..., D, D], b [..., D]."""
    return chol_solve_small(cholesky_small(H), b)


def inv_spd_small(H: jnp.ndarray) -> jnp.ndarray:
    """H^-1 for tiny SPD H [..., D, D] (D unrolled solves)."""
    D = H.shape[-1]
    L = cholesky_small(H)
    cols = []
    eye = jnp.eye(D, dtype=H.dtype)
    for k in range(D):
        e = jnp.broadcast_to(eye[k], H.shape[:-2] + (D,))
        cols.append(chol_solve_small(L, e))
    return jnp.stack(cols, axis=-1)
