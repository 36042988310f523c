"""Oriented BRIEF (ORB-class) descriptors, batched over keypoints.

Replacement for the reference's OpenCV ORB usage
(`extract_good_kp`, `kitti_ba.cpp:114-156`: 10000 features, 8 levels,
FAST_SCORE). Components:

- orientation by intensity centroid over a circular patch (the ORB "oFAST"
  moment method);
- rotation-steered binary tests from a fixed, seeded Gaussian BRIEF pattern
  (a deterministic pattern of the classic BRIEF construction — not a copy
  of OpenCV's learned table; matching quality is equivalent for VO-scale
  tracking and the pattern is reproducible from the seed);
- all point samples inside a keypoint's patch are computed with the same
  bilinear-folded one-hot matmuls over each keypoint's window.

Descriptors are produced as {-1, +1} float vectors [K, 256] so Hamming
distance becomes a single matmul (see ``epivo_tpu.frontend.match``),
plus a bit-packed uint32 view for storage/export parity.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from epivo_tpu.frontend.klt import _extract_windows

N_BITS = 256
PATCH = 31  # ORB patch diameter for moments/pattern
_S = 37  # window size: PATCH + margin for rotated samples


class Descriptors(NamedTuple):
    signs: jnp.ndarray  # [K, 256] float {-1, +1}
    packed: jnp.ndarray  # [K, 8] uint32 bit-packed
    angle: jnp.ndarray  # [K] radians
    valid: jnp.ndarray  # [K] bool


def brief_pattern(seed: int = 7) -> np.ndarray:
    """[256, 4] (ax, ay, bx, by) test-pair offsets, Gaussian BRIEF style:
    a ~ N(0, (PATCH/5)^2), b ~ N(a, (PATCH/10)^2)? — we use the classic
    G-II construction (both endpoints N(0, PATCH^2/25)), clipped to the
    patch radius."""
    rng = np.random.default_rng(seed)
    sigma = PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 4))
    r = PATCH // 2 - 2
    return np.clip(pts, -r, r).astype(np.float32)


_PATTERN = brief_pattern()


def _point_selection(q: jnp.ndarray, S: int):
    """Bilinear one-hot row/col weights for point samples.

    q: [K, P, 2] continuous sample positions (x, y) in window coords.
    Returns (Wy [K, P, S], Wx [K, P, S]).
    """
    dtype = q.dtype
    grid = jnp.arange(S, dtype=jnp.int32)[None, None, :]

    def onehots(coord):
        c = jnp.clip(coord, 0.0, S - 1.001)
        i0 = jnp.floor(c).astype(jnp.int32)[..., None]
        f = (c - jnp.floor(c)).astype(dtype)[..., None]
        return (grid == i0).astype(dtype) * (1 - f) + (grid == i0 + 1).astype(dtype) * f

    return onehots(q[..., 1]), onehots(q[..., 0])


def _sample_points(windows: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Bilinear point samples from [K, S, S] windows at q [K, P, 2] -> [K, P]."""
    S = windows.shape[-1]
    Wy, Wx = _point_selection(q, S)
    tmp = jnp.einsum("kpy,kyx->kpx", Wy, windows)
    return jnp.einsum("kpx,kpx->kp", tmp, Wx)


def orientation(windows: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid angle per window [K, S, S] -> [K] radians.

    Moments over the centered circular patch of diameter PATCH.
    """
    S = windows.shape[-1]
    c = (S - 1) / 2.0
    ys = jnp.arange(S, dtype=windows.dtype) - c
    xs = jnp.arange(S, dtype=windows.dtype) - c
    yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
    circ = (xx**2 + yy**2) <= (PATCH / 2.0) ** 2
    w = windows * circ
    m10 = jnp.sum(w * xx, axis=(-2, -1))
    m01 = jnp.sum(w * yy, axis=(-2, -1))
    return jnp.arctan2(m01, m10)


def detect_and_describe_pyramid(
    img: jnp.ndarray,
    threshold: float = 40.0,
    max_keypoints: int = 1024,
    n_levels: int = 8,
    scale_factor: float = 1.2,
):
    """Multi-scale ORB: FAST on a scale pyramid + oriented BRIEF.

    The reference's ORB configuration (10000 features, scale 1.2, 8 levels,
    FAST_SCORE — `kitti_ba.cpp:128`) with a fixed total budget: each level
    gets a keypoint budget proportional to its image area, detection and
    description run on the downscaled level (that is what buys scale
    invariance), and keypoint coordinates are mapped back to level-0
    pixels. Shapes are static for a fixed (image size, budget, levels)
    tuple — the level loop is a Python loop over static shapes, traced
    once under jit.

    Returns ``(Keypoints, Descriptors, levels)``: keypoints in level-0
    coordinates with FAST scores; full descriptors (signs, packed bits,
    orientation angles); and ``levels`` [K] int32 pyramid-level indices.
    """
    from epivo_tpu.frontend import fast as fast_mod, image as imops

    # Per-level budgets proportional to area (geometric series).
    areas = [scale_factor ** (-2 * l) for l in range(n_levels)]
    total = sum(areas)
    budgets = [max(8, int(round(max_keypoints * a / total))) for a in areas]
    # Adjust to exactly max_keypoints.
    budgets[0] += max_keypoints - sum(budgets)

    xs, scores, valids, levels = [], [], [], []
    sign_list, packed_list, angle_list = [], [], []
    cur = img
    cur_scale = 1.0
    for l in range(n_levels):
        if min(cur.shape) < 2 * PATCH:
            budgets[l] = 0
        if budgets[l] > 0:
            kp = fast_mod.detect(cur, threshold, budgets[l])
            d = describe(cur, kp.xy, kp.valid)
            xs.append(kp.xy * cur_scale)
            scores.append(kp.score)
            valids.append(kp.valid & d.valid)
            levels.append(jnp.full(kp.xy.shape[0], l, jnp.int32))
            sign_list.append(d.signs)
            packed_list.append(d.packed)
            angle_list.append(d.angle)
        if l < n_levels - 1:
            # 1.2x downscale via blur + bilinear resize (area-preserving).
            nh = max(int(round(cur.shape[0] / scale_factor)), 1)
            nw = max(int(round(cur.shape[1] / scale_factor)), 1)
            cur = jax.image.resize(imops._sep_conv3(
                cur,
                jnp.array([0.25, 0.5, 0.25], cur.dtype),
                jnp.array([0.25, 0.5, 0.25], cur.dtype),
            ), (nh, nw), method="linear")
            cur_scale *= scale_factor

    if not xs:
        raise ValueError(
            f"detect_and_describe_pyramid: image {img.shape} is smaller "
            f"than 2*PATCH={2 * PATCH} at every level — no level can "
            "host the oriented-BRIEF patch (use plain describe(), or a "
            "bigger image)."
        )
    from epivo_tpu.frontend.fast import Keypoints

    kps = Keypoints(
        xy=jnp.concatenate(xs),
        score=jnp.concatenate(scores),
        valid=jnp.concatenate(valids),
    )
    descs = Descriptors(
        signs=jnp.concatenate(sign_list),
        packed=jnp.concatenate(packed_list),
        angle=jnp.concatenate(angle_list),
        valid=kps.valid,
    )
    return kps, descs, jnp.concatenate(levels)


def describe(img: jnp.ndarray, xy: jnp.ndarray,
             valid: jnp.ndarray | None = None) -> Descriptors:
    """Compute oriented BRIEF descriptors at keypoints xy [K, 2]."""
    K_ = xy.shape[0]
    wins, origins = _extract_windows(img, xy, _S)
    ang = orientation(wins)
    ca, sa = jnp.cos(ang), jnp.sin(ang)

    pat = jnp.asarray(_PATTERN)  # [256, 4]
    ax, ay, bx, by = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]

    def rot(px, py):
        # [K, 256] rotated offsets
        rx = ca[:, None] * px[None, :] - sa[:, None] * py[None, :]
        ry = sa[:, None] * px[None, :] + ca[:, None] * py[None, :]
        return rx, ry

    rax, ray = rot(ax, ay)
    rbx, rby = rot(bx, by)

    # Window-coordinate positions of each sample (keypoint at center).
    ctr = xy - origins  # [K, 2] keypoint position within window
    qa = jnp.stack([ctr[:, 0:1] + rax, ctr[:, 1:2] + ray], axis=-1)  # [K,256,2]
    qb = jnp.stack([ctr[:, 0:1] + rbx, ctr[:, 1:2] + rby], axis=-1)

    va = _sample_points(wins, qa)
    vb = _sample_points(wins, qb)
    signs = jnp.where(va > vb, 1.0, -1.0).astype(img.dtype)  # [K, 256]

    bits = (signs > 0).astype(jnp.uint32).reshape(K_, 8, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    packed = jnp.sum(bits * weights, axis=-1).astype(jnp.uint32)  # [K, 8]

    v = jnp.ones(K_, bool) if valid is None else valid
    return Descriptors(signs=signs, packed=packed, angle=ang, valid=v)
