"""Batched robust model estimation: RANSAC and LMedS.

The reference calls OpenCV's serial ``findEssentialMat`` with per-driver
policies (SURVEY.md C13: RANSAC 0.95-0.999 / thresholds 0.01-1.0 px, LMedS
0.99). Here hypothesis generation, solving, and scoring are all batched:
``n_hyp`` minimal samples are drawn at once, solved with one vmapped
8-point SVD, scored against all N matches with one einsum, and reduced with
a single argmax — dense batched work, and the same shape scales across
devices by sharding the hypothesis axis (see
``epivo_tpu.parallel``).

Fixed shapes: both the match count N (padded, with ``mask``) and the
hypothesis count are static.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from epivo_tpu.geometry import essential

MIN_SAMPLE = 8  # 8-point minimal sample (see essential.py for rationale)


class RansacResult(NamedTuple):
    E: jnp.ndarray  # [3, 3] best (refit) essential matrix
    inliers: jnp.ndarray  # [N] bool
    n_inliers: jnp.ndarray  # [] int32
    best_score: jnp.ndarray  # [] hypothesis score (count or -median)


def n_iterations(confidence: float, outlier_ratio: float,
                 sample_size: int = MIN_SAMPLE) -> int:
    """Classic RANSAC iteration count: log(1-conf)/log(1-(1-out)^m)."""
    w = (1.0 - outlier_ratio) ** sample_size
    if w <= 0:
        return 1 << 14
    return max(1, int(math.ceil(math.log(max(1e-12, 1.0 - confidence))
                                / math.log(1.0 - min(w, 1 - 1e-12)))))


def _sample_indices(key, n_hyp: int, N: int, mask: jnp.ndarray | None,
                    sample_size: int = MIN_SAMPLE):
    """[n_hyp, sample_size] sample indices, approx. without replacement,
    valid-only.

    Gumbel-top-k over the validity mask: one sort per hypothesis, no
    data-dependent rejection loops.
    """
    g = jax.random.gumbel(key, (n_hyp, N))
    if mask is not None:
        g = jnp.where(mask[None, :], g, -jnp.inf)
    _, idx = jax.lax.top_k(g, sample_size)
    return idx


def ransac_essential(
    key,
    p: jnp.ndarray,
    p_t: jnp.ndarray,
    n_hyp: int = 512,
    threshold: float = 1e-3,
    mask: jnp.ndarray | None = None,
    method: str = "ransac",
    refit: bool = True,
    solver: str = "8pt",
    hyp_mesh=None,
) -> RansacResult:
    """Robust essential-matrix estimation over batched hypotheses.

    Args:
      p, p_t: [N, 3] normalized matches (padded; use ``mask``).
      n_hyp: static hypothesis count (e.g. from :func:`n_iterations`).
      threshold: Sampson inlier threshold in normalized units
        (pixel_threshold / focal_length — how OpenCV scales it internally).
      mask: [N] validity of the padded matches.
      method: "ransac" (inlier count) or "lmeds" (least median of squares,
        the reference's LMedS path `kitti_E.cpp:98-104`).
      refit: refit E on the winning inlier set (weighted 8-point).
      solver: "8pt" (projected 8-point minimal sample) or "5pt" (the true
        Nister/Stewenius minimal solver, `geometry/fivepoint.py` — each
        5-point sample yields up to 10 candidate E, all scored; needs only
        5 inliers per sample, which wins at high outlier ratios; the
        reference's OpenCV path, `kitti_E.cpp:98-104`).
      hyp_mesh: optional `jax.sharding.Mesh` with a 'hyp' axis — the
        hypothesis axis (minimal solves + Sampson scoring, the dominant
        H x N work) is then sharding-constrained over it, so a jit
        compiled against that mesh distributes hypotheses across devices
        and XLA reduces the argmax with one collective (the pod-scale
        RANSAC of `parallel.dist`, reachable from INSIDE the jitted VO
        step). None = no constraint (single device).

    Returns: :class:`RansacResult`.
    """
    N = p.shape[0]
    valid = mask if mask is not None else jnp.ones((N,), bool)
    n_valid = jnp.sum(valid)

    sample_size = 5 if solver == "5pt" else MIN_SAMPLE
    idx = _sample_indices(key, n_hyp, N, mask, sample_size)
    p_s = p[idx]  # [n_hyp, sample_size, 3]
    p_ts = p_t[idx]
    if solver == "5pt":
        from epivo_tpu.geometry import fivepoint

        Es_c, hyp_ok = fivepoint.five_point(p_s, p_ts)  # [n_hyp, 10, 3, 3]
        Es = Es_c.reshape(n_hyp * 10, 3, 3)
        hyp_ok = hyp_ok.reshape(n_hyp * 10)
    else:
        # Hypotheses ARE projected to the essential manifold: besides
        # matching OpenCV semantics, the projection regularizes
        # near-degenerate minimal samples (forward motion / low parallax
        # leave AtA with a ~3D near-null space, and the raw null vector is
        # then unstable).
        Es = essential.eight_point(p_s, p_ts, project=True)  # [n_hyp, 3, 3]
        hyp_ok = jnp.ones((n_hyp,), bool)

    if hyp_mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as _P

        Es = jax.lax.with_sharding_constraint(
            Es, NamedSharding(hyp_mesh, _P("hyp", None, None)))

    err = essential.sampson_error(Es, p[None], p_t[None])  # [H, N]
    if hyp_mesh is not None:
        err = jax.lax.with_sharding_constraint(
            err, NamedSharding(hyp_mesh, _P("hyp", None)))
    err = jnp.where(valid[None, :] & hyp_ok[:, None], err, jnp.inf)

    if method == "lmeds":
        # Median over valid entries: sort and index at n_valid // 2.
        err_sorted = jnp.sort(jnp.where(valid[None, :], err, jnp.inf), axis=-1)
        med = err_sorted[:, jnp.clip(n_valid // 2, 0, N - 1)]
        score = -med
        best = jnp.argmax(score)
        best_med = med[best]
        # OpenCV-style robust sigma from the best median
        # (modules/calib3d LMeDS): 2.5 * 1.4826 * (1 + 5/(n-8)) * sqrt(med).
        sigma = 2.5 * 1.4826 * (1.0 + 5.0 / jnp.maximum(n_valid - 8, 1)) * jnp.sqrt(
            jnp.maximum(best_med, 1e-18)
        )
        # Units: Sampson errors, ``best_med``, and the caller's ``threshold``
        # are all SQUARED normalized-coordinate quantities; sigma is linear,
        # so the inlier gate compares err < sigma^2. The user threshold acts
        # as a floor so a razor-sharp median (e.g. exact synthetic data)
        # cannot collapse the inlier set below the caller's pixel tolerance.
        thr = jnp.maximum(sigma * sigma, jnp.asarray(threshold, p.dtype))
    else:
        inl = (err < threshold) & valid[None, :]
        score = jnp.sum(inl, axis=-1).astype(p.dtype)
        best = jnp.argmax(score)
        thr = jnp.asarray(threshold, p.dtype)

    E_best = Es[best]
    inliers = (essential.sampson_error(E_best, p, p_t) < thr) & valid
    if refit:
        # Guarded refit (LO-RANSAC style): near-degenerate geometries
        # (forward motion / low parallax) make the all-inlier least-squares
        # E unstable — keep the refit only if it has >= 8 support points
        # AND does not lose inliers versus the winning hypothesis.
        w = inliers.astype(p.dtype)
        E_refit = essential.eight_point(p, p_t, weights=w)
        inl_refit = (essential.sampson_error(E_refit, p, p_t) < thr) & valid
        use_refit = (jnp.sum(inliers) >= MIN_SAMPLE) & (
            jnp.sum(inl_refit) >= jnp.sum(inliers)
        )
        E_final = jnp.where(use_refit, E_refit, E_best)
        inliers = jnp.where(use_refit, inl_refit, inliers)
    else:
        E_final = E_best

    return RansacResult(
        E=E_final,
        inliers=inliers,
        n_inliers=jnp.sum(inliers).astype(jnp.int32),
        best_score=score[best],
    )
