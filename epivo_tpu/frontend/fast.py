"""FAST-9/16 corner detection as dense, fixed-shape tensor ops.

Replacement for the reference's OpenCV FAST usage
(`extract_kp` / `extract_kp_stereo`, ref `kitti_ba.cpp:39-111`;
threshold-40 sites `kitti_ba.cpp:47`, `kitti_E.cpp:71`). Instead of a
serial scan producing a variable-length keypoint vector, the whole image is
tested at once (16 rolled copies + segment tests), scored,
3x3-NMS'd, and reduced to a *fixed keypoint budget* with ``top_k`` — the
score-ranked truncation that keeps every downstream shape static
(SURVEY.md §7 "fixed budgets + validity masks").

The detector is exact FAST-9/16 (same arc test and score as OpenCV's
``FastFeatureDetector`` with nonmaxSuppression=true): score = the largest
threshold at which the pixel is still a corner.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3: 16 (dy, dx) offsets in clockwise order
# starting from the top — the standard FAST-16 ring.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC = 9  # FAST-9: at least 9 contiguous circle pixels all brighter/darker


class Keypoints(NamedTuple):
    """Fixed-budget keypoint set."""

    xy: jnp.ndarray  # [K, 2] float (x, y) pixel coordinates
    score: jnp.ndarray  # [K] detector response
    valid: jnp.ndarray  # [K] bool


def _ring_values(img: jnp.ndarray) -> jnp.ndarray:
    """[16, H, W] circle-pixel values via rolled copies (border wraps are
    masked out by the caller's border exclusion)."""
    return jnp.stack(
        [jnp.roll(img, (-dy, -dx), axis=(0, 1)) for dy, dx in CIRCLE]
    )


def fast_score_map(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Dense FAST-9/16 corner response. img [H, W] (grayscale, any float
    scale); returns [H, W] scores, 0 for non-corners.

    Score: max over the 16 arcs of length 9 of (min over the arc of
    |v_i - c|) - but only for arcs where the segment test passes; this is
    the exact "largest threshold still a corner" FAST score.
    """
    dtype = img.dtype
    H, W = img.shape
    ring = _ring_values(img)  # [16, H, W]
    c = img[None]
    diff = ring - c  # [16, H, W]

    # For each arc start k: bright arc iff min_j diff[k+j] > t;
    # dark arc iff max_j diff[k+j] < -t.
    idx = (jnp.arange(16)[:, None] + jnp.arange(ARC)[None, :]) % 16  # [16, 9]
    arc_vals = diff[idx]  # [16, 9, H, W]
    arc_min = jnp.min(arc_vals, axis=1)  # [16, H, W]
    arc_max = jnp.max(arc_vals, axis=1)

    bright_score = jnp.max(arc_min, axis=0)  # largest t with a bright arc
    dark_score = jnp.max(-arc_max, axis=0)  # largest t with a dark arc
    score = jnp.maximum(bright_score, dark_score)
    score = jnp.where(score > threshold, score, 0.0)

    # Exclude a 3-pixel border (the ring would wrap around the image).
    yy = jnp.arange(H)[:, None]
    xx = jnp.arange(W)[None, :]
    interior = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    return jnp.where(interior, score, 0.0).astype(dtype)


def nms3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression (keep strict local maxima)."""
    H, W = score.shape
    p = jnp.pad(score, 1, mode="constant", constant_values=-jnp.inf)
    neigh = jnp.stack(
        [
            p[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if not (dy == 0 and dx == 0)
        ]
    )
    keep = score >= jnp.max(neigh, axis=0)
    return jnp.where(keep, score, 0.0)


def top_k_keypoints(score: jnp.ndarray, k: int,
                    two_stage: bool | None = None) -> Keypoints:
    """Rank-select a fixed budget of keypoints from a dense score map.

    ``jax.lax.top_k`` over a full frame (~0.5M lanes) is a sort-class op;
    the two-stage path (default on for large maps) first reduces each
    16x16 block to its top-8 NMS survivors with 8 masked max-reductions
    (elementwise), then runs the exact top-k over the ~3% of candidates that
    remain. Exact unless one 16x16 block holds more than 8 of the global
    top-k survivors — with 3x3 NMS spacing that needs pathologically dense
    corners, and a miss only swaps tail-of-budget keypoints.
    """
    H, W = score.shape
    if two_stage is None:
        two_stage = H * W >= 1 << 16
    if not two_stage:
        flat = score.reshape(-1)
        vals, idx = jax.lax.top_k(flat, k)
        ys = (idx // W).astype(score.dtype)
        xs = (idx % W).astype(score.dtype)
        return Keypoints(
            xy=jnp.stack([xs, ys], axis=-1), score=vals, valid=vals > 0.0,
        )

    B, M = 16, 8  # block edge, candidates per block
    Hp = ((H + B - 1) // B) * B
    Wp = ((W + B - 1) // B) * B
    s = jnp.pad(score, ((0, Hp - H), (0, Wp - W)))
    blocks = s.reshape(Hp // B, B, Wp // B, B).transpose(0, 2, 1, 3)
    nb = (Hp // B) * (Wp // B)
    blocks = blocks.reshape(nb, B * B)

    cand_v, cand_i = [], []
    cur = blocks
    lane = jnp.arange(B * B)[None, :]
    for _ in range(M):
        idx = jnp.argmax(cur, axis=-1)  # [nb]
        val = jnp.max(cur, axis=-1)
        cand_v.append(val)
        cand_i.append(idx)
        # Mask the winner with a full-tile select (no scatter).
        cur = jnp.where(lane == idx[:, None], -jnp.inf, cur)
    cv = jnp.stack(cand_v, -1)  # [nb, M]
    ci = jnp.stack(cand_i, -1)

    # Global flat index of each candidate.
    by = (jnp.arange(nb) // (Wp // B)) * B
    bx = (jnp.arange(nb) % (Wp // B)) * B
    iy = by[:, None] + ci // B
    ix = bx[:, None] + ci % B
    inb = (iy < H) & (ix < W)
    cv = jnp.where(inb, cv, 0.0)

    vals, sel = jax.lax.top_k(cv.reshape(-1), k)
    ys = iy.reshape(-1)[sel].astype(score.dtype)
    xs = ix.reshape(-1)[sel].astype(score.dtype)
    return Keypoints(
        xy=jnp.stack([xs, ys], axis=-1), score=vals, valid=vals > 0.0,
    )


def detect(img: jnp.ndarray, threshold: float = 40.0, max_keypoints: int = 1024,
           nms: bool = True) -> Keypoints:
    """FAST detection with a fixed keypoint budget.

    Equivalent workload to `FastFeatureDetector::create(40)` + detect
    (ref `kitti_E.cpp:71-74`), with score-ranked truncation replacing the
    variable-length output. The score map and NMS are plain stencils that
    XLA fuses.
    """
    s = fast_score_map(img, threshold)
    if nms:
        s = nms3(s)
    return top_k_keypoints(s, max_keypoints)
