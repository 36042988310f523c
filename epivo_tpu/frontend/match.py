"""Descriptor matching: Hamming distance as one matmul.

Replacement for the reference's brute-force Hamming matcher
(``BFMatcher(NORM_HAMMING2, crossCheck=true)``, `kitti_ba.cpp:602,640-693`).
With descriptors as {-1,+1} vectors d of length B, the Hamming distance is
    H(a, b) = (B - a . b) / 2,
so the full N1 x N2 distance table is a single [N1,B]x[B,N2] matmul — the
exact computation OpenCV does with popcounts, as one dense product.
Cross-check (mutual nearest neighbor) and Lowe ratio tests are
masked argmin reductions.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

_BIG = jnp.inf


class MatchResult(NamedTuple):
    idx: jnp.ndarray  # [N1] best match in set 2 (or -1)
    dist: jnp.ndarray  # [N1] Hamming distance of best match
    valid: jnp.ndarray  # [N1] bool — passed cross-check/ratio/threshold


def hamming_table(signs1: jnp.ndarray, signs2: jnp.ndarray) -> jnp.ndarray:
    """[N1, B] x [N2, B] {-1,+1} descriptors -> [N1, N2] Hamming distances."""
    B = signs1.shape[-1]
    dot = signs1 @ signs2.T
    return (B - dot) * 0.5


def match(
    signs1: jnp.ndarray,
    signs2: jnp.ndarray,
    valid1: jnp.ndarray | None = None,
    valid2: jnp.ndarray | None = None,
    cross_check: bool = True,
    max_dist: float = 80.0,
    ratio: float | None = None,
) -> MatchResult:
    """Nearest-neighbor Hamming matching with optional cross-check / ratio.

    max_dist: absolute Hamming gate (256-bit descriptors; OpenCV-style
    pipelines typically gate at 64-90). ratio: Lowe ratio vs 2nd-best.
    """
    D = hamming_table(signs1, signs2)  # [N1, N2]
    if valid1 is not None:
        D = jnp.where(valid1[:, None], D, _BIG)
    if valid2 is not None:
        D = jnp.where(valid2[None, :], D, _BIG)

    best2 = jnp.argmin(D, axis=1)  # [N1]
    dist = jnp.min(D, axis=1)
    ok = dist <= max_dist

    if ratio is not None:
        N2 = D.shape[1]
        second = jnp.min(
            jnp.where(
                jnp.arange(N2)[None, :] == best2[:, None], _BIG, D
            ),
            axis=1,
        )
        ok = ok & (dist < ratio * second)

    if cross_check:
        best1 = jnp.argmin(D, axis=0)  # [N2] best row for each column
        mutual = best1[best2] == jnp.arange(D.shape[0])
        ok = ok & mutual

    idx = jnp.where(ok, best2, -1)
    return MatchResult(idx=idx, dist=dist, valid=ok)
