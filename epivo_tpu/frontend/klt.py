"""Pyramidal Lucas-Kanade optical flow, batched over keypoints.

Replacement for the reference's ``calcOpticalFlowPyrLK`` sites
(`kitti_ba.cpp:220-228,296-304`, `kitti_E.cpp:82-95`, `euroc.cpp:189-202`).
Same algorithm and defaults as OpenCV (21x21 window, 3+1 pyramid levels,
30 iterations / 0.01 epsilon termination, min-eigenvalue rejection).

Structure, per pyramid level:

1. **Window extraction**: per keypoint, ONE ``dynamic_slice`` pulls an
   integer-aligned (win + 2*margin + 1)^2 search window. The template and
   its gradients are sampled once from the source window.
2. **Iteration loop**: on CUDA backends it runs as one fused Pallas
   (Triton) kernel per level (``pallas_klt.lk_iterate``), which reads the
   target image directly; on other backends as a ``lax.scan`` over the
   extracted target windows. The choice is made at lowering time from the
   platform (``lax.platform_dependent``); both compute the same iterates.

Border handling: window origins clamp at image borders, and the *effective*
template center is tracked explicitly so clamping never biases the flow.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from epivo_tpu.frontend import image as imops, pallas_klt


class FlowResult(NamedTuple):
    xy: jnp.ndarray  # [K, 2] tracked positions in the target image
    status: jnp.ndarray  # [K] bool
    err: jnp.ndarray  # [K] mean absolute patch residual


def _window_origins(shape: tuple[int, int], centers: jnp.ndarray,
                    size: int) -> jnp.ndarray:
    """[K, 2] int32 (x, y) top-left corners of size x size windows centred
    on ``centers``, clamped so every window lies inside the image."""
    H, W = shape
    r = size // 2
    c_int = jnp.round(centers).astype(jnp.int32)
    ox = jnp.clip(c_int[:, 0] - r, 0, W - size)
    oy = jnp.clip(c_int[:, 1] - r, 0, H - size)
    return jnp.stack([ox, oy], axis=-1)


def _extract_windows(img: jnp.ndarray, centers: jnp.ndarray, size: int):
    """[K] integer-aligned size x size windows (a vmapped ``dynamic_slice``).

    Returns (windows [K, size, size], origins [K, 2]) where origins are the
    *actual* clamped top-left corners — callers must use them (border
    clamping shifts the window off-center).
    """
    o = _window_origins(img.shape, centers, size)

    def slice_one(y, x):
        return jax.lax.dynamic_slice(img, (y, x), (size, size))

    wins = jax.vmap(slice_one)(o[:, 1], o[:, 0])
    return wins, o.astype(img.dtype)


def _grad_batch(wins: jnp.ndarray):
    """Scharr gradients over a stack of windows [K, S, S] (edge padded)."""
    s = jnp.array([3.0, 10.0, 3.0], wins.dtype) / 16.0
    d = jnp.array([-1.0, 0.0, 1.0], wins.dtype) * 0.5
    K_, S, _ = wins.shape
    p = jnp.pad(wins, ((0, 0), (1, 1), (1, 1)), mode="edge")

    def sep(kx, ky):
        h = sum(p[:, :, i : i + S] * kx[i] for i in range(3))  # [K, S+2, S]
        return sum(h[:, i : i + S, :] * ky[i] for i in range(3))  # [K, S, S]

    return sep(d, s), sep(s, d)


def _shift_select(v: jnp.ndarray, idx: jnp.ndarray, out_len: int, n_off: int,
                  axis: int) -> jnp.ndarray:
    """Per-lane dynamic shift along ``axis`` via binary-decomposed selects.

    v: [..., K] stack with the keypoint axis last; idx [K] integer
    offsets in [0, n_off). Semantically returns
    ``v[..., idx:idx+out_len, ...]`` per keypoint, as ceil(log2(n_off))
    two-way ``where`` stages over statically shifted views — O(log n)
    elementwise selects instead of the O(n) masked select-sum, no gathers.
    """
    nbits = max(1, int(n_off - 1)).bit_length()
    shifts = [1 << b for b in range(nbits)][::-1]
    need = out_len + sum(shifts)
    L = v.shape[axis]
    if L < need:  # pad (never selected: idx + out_len <= L by contract)
        pad = [(0, 0)] * v.ndim
        pad[axis] = (0, need - L)
        v = jnp.pad(v, pad)
    rem = need
    cur = jax.lax.slice_in_dim(v, 0, need, axis=axis)
    bshape = [1] * v.ndim
    bshape[-1] = idx.shape[0]
    for s in shifts:
        rem -= s
        bit = ((idx & s) != 0).reshape(bshape)
        cur = jnp.where(
            bit,
            jax.lax.slice_in_dim(cur, s, s + rem, axis=axis),
            jax.lax.slice_in_dim(cur, 0, rem, axis=axis),
        )
    return cur


def _sample_lanes(wins_T: jnp.ndarray, q: jnp.ndarray, win: int) -> jnp.ndarray:
    """Keypoint-last bilinear patch sampling via binary-shift selects.

    wins_T: [S, S, K] windows with the keypoint axis last.
    q: [K, 2] continuous top-left corners (clamped to [0, S - win - 1)).
    Returns [win, win, K].

    The per-keypoint integer offset is applied by :func:`_shift_select`
    (log2(S - win) two-way selects over statically shifted views, no
    gathers); the fractional part is the usual 4-tap blend of statically
    shifted views.
    """
    S = wins_T.shape[0]
    n_off = S - win  # integer offsets 0 .. S-win-1
    hi = n_off - 1e-3
    qx = jnp.clip(q[:, 0], 0.0, hi)
    qy = jnp.clip(q[:, 1], 0.0, hi)
    ix = jnp.floor(qx).astype(jnp.int32)
    iy = jnp.floor(qy).astype(jnp.int32)
    fx = (qx - jnp.floor(qx))[None, None, :]
    fy = (qy - jnp.floor(qy))[None, None, :]

    acc_y = _shift_select(wins_T, iy, win + 1, n_off, axis=0)  # [win+1, S, K]
    acc = _shift_select(acc_y, ix, win + 1, n_off, axis=1)  # [win+1, win+1, K]
    return (
        acc[:win, :win] * (1 - fx) * (1 - fy)
        + acc[:win, 1:] * fx * (1 - fy)
        + acc[1:, :win] * (1 - fx) * fy
        + acc[1:, 1:] * fx * fy
    )


def _lk_iterate_scan(tgt, o_t, T, Ix, Iy, q0, S: int, iters: int,
                     eps: float):
    """The LK iteration loop as a ``lax.scan`` over extracted windows.

    tgt: [H, W] target level; o_t: [K, 2] int32 origins (x, y) of the
    S x S search windows; T/Ix/Iy: [win, win, K] template and gradients;
    q0: [K, 2] top-left patch corners in window coordinates, within
    [0, S - win - 1). Returns (q_fin [K, 2], err [K]) with err the mean
    absolute residual at q_fin. A keypoint freezes once its step is shorter
    than ``eps``.
    """
    win = T.shape[0]
    hi = S - win - 1 - 1e-3
    tgt_lanes = jnp.transpose(
        jax.vmap(lambda y, x: jax.lax.dynamic_slice(tgt, (y, x), (S, S)))(
            o_t[:, 1], o_t[:, 0]), (1, 2, 0))
    Gxx = jnp.sum(Ix * Ix, axis=(0, 1))
    Gxy = jnp.sum(Ix * Iy, axis=(0, 1))
    Gyy = jnp.sum(Iy * Iy, axis=(0, 1))
    det = Gxx * Gyy - Gxy * Gxy
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)

    def body(carry, _):
        q, done = carry
        P = _sample_lanes(tgt_lanes, q, win)
        dI = P - T
        bx = jnp.sum(dI * Ix, axis=(0, 1))
        by = jnp.sum(dI * Iy, axis=(0, 1))
        dx = -(Gyy * bx - Gxy * by) * inv_det
        dy = -(-Gxy * bx + Gxx * by) * inv_det
        step = jnp.stack([dx, dy], axis=-1)  # [K, 2]
        q_new = jnp.where(done[:, None], q, jnp.clip(q + step, 0.0, hi))
        done_new = done | (jnp.linalg.norm(step, axis=-1) < eps)
        return (q_new, done_new), None

    (q_fin, _), _ = jax.lax.scan(
        body, (q0, jnp.zeros(q0.shape[0], bool)), None, length=iters)
    err = jnp.mean(jnp.abs(_sample_lanes(tgt_lanes, q_fin, win) - T),
                   axis=(0, 1))
    return q_fin, err


def _lk_iterate_kernel(tgt, o_t, T, Ix, Iy, q0, S: int, iters: int,
                       eps: float, interpret: bool = False):
    """:func:`_lk_iterate_scan`'s contract through the fused Triton kernel
    (keypoint-major operands; the kernel reads the target image itself).
    ``interpret=True`` runs the kernel on the CPU, for tests."""
    to_kmajor = lambda a: jnp.transpose(a, (2, 0, 1))
    return pallas_klt.lk_iterate(tgt, o_t, to_kmajor(T), to_kmajor(Ix),
                                 to_kmajor(Iy), q0, S, iters, eps,
                                 interpret=interpret)


def _lk_iterate(tgt, o_t, T, Ix, Iy, q0, S: int, iters: int, eps: float):
    """The LK iteration loop for the platform being compiled for: the fused
    kernel on CUDA, the scan elsewhere (resolved at lowering time)."""
    run = lambda impl: lambda *a: impl(*a, S, iters, eps)
    return jax.lax.platform_dependent(
        tgt, o_t, T, Ix, Iy, q0,
        cuda=run(_lk_iterate_kernel), default=run(_lk_iterate_scan))


def _track_level(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    pt_src: jnp.ndarray,
    guess: jnp.ndarray,
    win: int,
    margin: int,
    iters: int,
    eps: float,
    min_eig: float,
    n_chunks: int = 2,
):
    """One pyramid level of LK for all points at once.

    pt_src / guess: [K, 2] positions at this level's scale.
    Returns (new_guess [K, 2], ok [K], err [K]).
    """
    S = win + 2 * margin + 1
    hi = S - win - 1 - 1e-3

    # --- source: template + gradients, one extraction ---
    src_wins, o_s = _extract_windows(src, pt_src, S)
    gx, gy = _grad_batch(src_wins)
    q_s = jnp.clip(pt_src - o_s - (win - 1) / 2.0, 0.0, hi)
    # Effective template centers (clamp-aware; see module docstring).
    c_eff = o_s + q_s + (win - 1) / 2.0

    to_lanes = lambda w: jnp.transpose(w, (1, 2, 0))
    T = _sample_lanes(to_lanes(src_wins), q_s, win)
    Ix = _sample_lanes(to_lanes(gx), q_s, win)
    Iy = _sample_lanes(to_lanes(gy), q_s, win)

    Gxx = jnp.sum(Ix * Ix, axis=(0, 1))
    Gxy = jnp.sum(Ix * Iy, axis=(0, 1))
    Gyy = jnp.sum(Iy * Iy, axis=(0, 1))
    det = Gxx * Gyy - Gxy * Gxy
    trace = Gxx + Gyy
    min_ev = (trace - jnp.sqrt(jnp.maximum(trace * trace - 4 * det, 0.0))) / 2.0
    ok = min_ev / (win * win) > min_eig

    # --- target: iterate inside margin windows; re-center between chunks ---
    chunk_iters = max(1, iters // n_chunks)
    g = guess + (c_eff - pt_src)  # track the effective template center
    err = None
    for _ in range(n_chunks):
        o_t = _window_origins(tgt.shape, g, S)
        o_tf = o_t.astype(g.dtype)
        q0 = jnp.clip(g - o_tf - (win - 1) / 2.0, 0.0, hi)
        q_fin, err = _lk_iterate(tgt, o_t, T, Ix, Iy, q0, S, chunk_iters, eps)
        g = q_fin + o_tf + (win - 1) / 2.0

    # Position of pt_src's content = pt_src + measured template flow.
    return pt_src + (g - c_eff), ok, err


def track(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    pts: jnp.ndarray,
    valid: jnp.ndarray | None = None,
    win: int = 21,
    levels: int = 4,
    iters: int = 30,
    eps: float = 0.01,
    min_eig: float = 1e-4,
    max_err: float = 1e9,
    margin: int | tuple[int, ...] | list[int] | None = None,
    n_chunks: int = 1,
) -> FlowResult:
    """Track points from src to tgt image. pts [K, 2] (x, y) pixels.

    OpenCV-default-equivalent configuration: winSize 21, maxLevel 3
    (4 levels), 30 iterations, eps 0.01. ``margin`` bounds per-chunk
    displacement per level — an int (same at every level) or a per-level
    sequence indexed by pyramid level (entry 0 = full resolution);
    ``n_chunks`` re-centers the search window between iteration chunks to
    extend the range. The default schedule keeps margin 12 at the top
    level (where the unknown full motion must be absorbed) and shrinks to
    6 at the fine levels, where the incoming coarse-level guess leaves
    only a subpixel-to-few-pixel residual: window extraction + gradient
    cost scales with (win + 2*margin + 1)^2.
    """
    if margin is None:
        # Residual flow halves per refined level; 6 px covers it generously.
        margin = [6] * levels
        margin[levels - 1] = 12
    elif isinstance(margin, int):
        margin = [margin] * levels
    margin = list(margin)
    assert len(margin) == levels

    pyr_s = imops.build_pyramid(src, levels)
    pyr_t = imops.build_pyramid(tgt, levels)

    # Small top levels must still fit the slice window: pad bottom/right
    # with edge replication (coordinates are unaffected).
    S_max = win + 2 * max(margin) + 1

    def pad_to_window(im):
        ph = max(0, S_max - im.shape[0])
        pw = max(0, S_max - im.shape[1])
        if ph or pw:
            im = jnp.pad(im, ((0, ph), (0, pw)), mode="edge")
        return im

    pyr_s = [pad_to_window(im) for im in pyr_s]
    pyr_t = [pad_to_window(im) for im in pyr_t]

    scale_top = 2.0 ** (levels - 1)
    g = pts / scale_top
    ok = jnp.ones(pts.shape[0], bool)
    err = jnp.zeros(pts.shape[0], pts.dtype)
    for lvl in range(levels - 1, -1, -1):
        scale = 2.0**lvl
        p_lvl = pts / scale
        g, ok_lvl, err = _track_level(
            pyr_s[lvl], pyr_t[lvl], p_lvl, g, win, margin[lvl], iters, eps,
            min_eig, n_chunks=n_chunks,
        )
        ok = ok & ok_lvl
        if lvl > 0:
            g = g * 2.0

    H, W = tgt.shape
    inb = (
        (g[:, 0] >= 0) & (g[:, 0] <= W - 1) & (g[:, 1] >= 0) & (g[:, 1] <= H - 1)
    )
    status = ok & inb & (err < max_err)
    if valid is not None:
        status = status & valid
    return FlowResult(xy=g, status=status, err=err)
