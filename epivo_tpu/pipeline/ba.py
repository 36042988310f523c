"""Windowed bundle adjustment pipelines — the kitti_ba-equivalent layer.

The reference processes sliding windows serially on one CPU thread
(`bundle_adjustment` `kitti_ba.cpp:757-905`, `bundle_adjustment_stereo`
`:908-1068`), with busy-wait handoff from the matcher thread. Here the
window axis is a *batch axis*: every window's LM solve runs simultaneously
(`lm.solve_batched`), which is both the single-device win (windows fill
the device) and the multi-device scaling axis (shard windows over the mesh — see
``epivo_tpu.parallel``).

Window structure (mono, ws=3, stride ws-1 — ref `kitti_ba.cpp:1133-1147`):
  frames {i, i+1, i+2}; zetas z0: i->i+1, z1: i+1->i+2 (owned by this
  window; stride ws-1 tiles the zeta axis exactly);
  constraints: (i,i+1) span (0,0); (i+1,i+2) span (1,1); (i,i+2) span (0,1).

Stereo (ref `robust_ass_stereo` `kitti_ba.cpp:352-581`): frame index space
doubled (2i = L_i, 2i+1 = R_i); zetas alternate rig (L_i->R_i) and cross
(R_i->L_{i+1}). The reference encodes the known baseline as a zero-weight
constraint with placeholder points (`:567-574`) while still letting LM move
the rig pose; we instead *freeze* rig zetas at the calibrated transform via
``zeta_mask`` (exact, and strictly stronger — documented deviation), with
the reference's w=0 scheme also available.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from epivo_tpu.geometry import se3
from epivo_tpu.optim import lm
from epivo_tpu.pipeline.config import BAConfig


class WindowSpec(NamedTuple):
    """Static structure shared by every window."""

    n_zeta: int
    reps: np.ndarray  # [R, 2] zeta spans (window-local)
    frame_pairs: np.ndarray  # [R, 2] window-local *frame* offsets (for matching)
    zeta_mask: np.ndarray | None  # [Z] False = frozen (stereo rig zetas)


def mono_window_spec(ws: int = 3) -> WindowSpec:
    """Consecutive-pair constraints + the anchor skip constraint."""
    n_zeta = ws - 1
    reps = [(j, j) for j in range(n_zeta)]
    pairs = [(j, j + 1) for j in range(n_zeta)]
    if ws >= 3:
        reps.append((0, n_zeta - 1))
        pairs.append((0, ws - 1))
    return WindowSpec(
        n_zeta=n_zeta,
        reps=np.asarray(reps, np.int32),
        frame_pairs=np.asarray(pairs, np.int32),
        zeta_mask=None,
    )


def stereo_window_spec(ws: int = 3, freeze_rig: bool = True) -> WindowSpec:
    """Doubled-index stereo window.

    Window-local doubled frames: 0=L_0, 1=R_0, 2=L_1, ... (2k = L_k).
    Zetas: even = rig L_k->R_k, odd = cross R_k->L_{k+1}.
    Constraints per temporal step k (ref `kitti_ba.cpp:552-574`):
      L_k->L_{k+1}: zeta span (2k, 2k+1), w=1
      R_k->L_{k+1}: span (2k+1, 2k+1),  w=1
      L_k->R_k   : span (2k, 2k),      w=0 (baseline; frozen instead when
                                            ``freeze_rig``)
    """
    n_step = ws - 1
    n_zeta = 2 * n_step
    reps, pairs, w = [], [], []
    for k in range(n_step):
        reps.append((2 * k, 2 * k + 1)); pairs.append((2 * k, 2 * k + 2)); w.append(1.0)
        reps.append((2 * k + 1, 2 * k + 1)); pairs.append((2 * k + 1, 2 * k + 2)); w.append(1.0)
        reps.append((2 * k, 2 * k)); pairs.append((2 * k, 2 * k + 1)); w.append(0.0)
    zmask = None
    if freeze_rig:
        zmask = np.ones(n_zeta, bool)
        zmask[0::2] = False  # rig zetas frozen at calibration
    spec = WindowSpec(
        n_zeta=n_zeta,
        reps=np.asarray(reps, np.int32),
        frame_pairs=np.asarray(pairs, np.int32),
        zeta_mask=zmask,
    )
    spec_weights = np.asarray(w, np.float32)
    return spec, spec_weights


class BAWindowsResult(NamedTuple):
    T_opt: jnp.ndarray  # [W, Z, 4, 4] optimized (or reverted) zeta poses
    r_norm: jnp.ndarray  # [W]
    reverted: jnp.ndarray  # [W] bool — window exceeded revert threshold
    n_accepted: jnp.ndarray  # [W] int32 LM accepted-step counts


def ba_windows(
    T0s: jnp.ndarray,
    spec: WindowSpec,
    p: jnp.ndarray,
    p_t: jnp.ndarray,
    wreps: jnp.ndarray | None = None,
    pmask: jnp.ndarray | None = None,
    config: BAConfig = BAConfig(),
    use_lanes: bool = True,
) -> BAWindowsResult:
    """Batched windowed BA.

    Args:
      T0s: [W, Z, 4, 4] initial zeta poses per window.
      spec: shared window structure.
      p, p_t: [W, R, N, 3] normalized matches per window constraint.
      wreps: [W, R] constraint weights.
      pmask: [W, R, N] point validity.
      use_lanes: solve with the window-last LM (``optim.lm_lanes``) —
        identical semantics to the vmapped reference-layout solver
        (``optim.lm``); which is faster on the GPU is measured by
        ``chip_smoke.py``.

    Underfilled constraints should be zero-weighted by the caller
    (ref `kitti_ba.cpp:821-826`); windows whose final residual norm exceeds
    ``config.lm.revert_r_norm`` revert to their initialization
    (ref `kitti_ba.cpp:892-894,1055-1057`).
    """
    lc = config.lm
    if use_lanes:
        from epivo_tpu.optim import lm_lanes

        res = lm_lanes.solve_batched_lanes(
            T0s, spec.reps, p, p_t, wreps=wreps, pmask=pmask,
            zeta_mask=spec.zeta_mask, lambda0=lc.lambda0, epsilon=lc.epsilon,
            max_iters=lc.max_iters, huber_delta=lc.huber_delta,
        )
    else:
        reps = jnp.asarray(spec.reps)
        zmask = (None if spec.zeta_mask is None
                 else jnp.asarray(spec.zeta_mask))

        def solve_one(T0, pp, pt, w, pm):
            return lm.solve(
                T0, reps, pp, pt, wreps=w, pmask=pm, zeta_mask=zmask,
                lambda0=lc.lambda0, epsilon=lc.epsilon,
                max_iters=lc.max_iters, huber_delta=lc.huber_delta,
            )

        res = jax.vmap(
            solve_one,
            in_axes=(0, 0, 0, 0 if wreps is not None else None,
                     0 if pmask is not None else None),
        )(T0s, p, p_t, wreps, pmask)

    reverted = res.r_norm > lc.revert_r_norm
    T_opt = jnp.where(reverted[:, None, None, None], T0s, res.T0s)
    return BAWindowsResult(
        T_opt=T_opt, r_norm=res.r_norm, reverted=reverted,
        n_accepted=res.n_accepted,
    )


def stitch_windows(T_opt: jnp.ndarray) -> jnp.ndarray:
    """Concatenate window-owned zetas into one chain.

    With stride == ws-1 each window owns its zetas exclusively
    (window w covers global zetas [w*Z, (w+1)*Z)), so stitching is a
    reshape: [W, Z, 4, 4] -> [W*Z, 4, 4].
    """
    W, Z = T_opt.shape[:2]
    return T_opt.reshape(W * Z, 4, 4)


def trajectory_from_zetas(zetas: jnp.ndarray) -> jnp.ndarray:
    """Accumulate camera-to-world trajectory from zeta chain.

    zeta j maps frame j -> frame j+1, so the world pose of frame k is
    cT_k = inv(T_0) @ inv(T_1) ... — equivalently cT_{k+1} = cT_k @ inv(T_k)
    (the reference's composition `kitti_ba.cpp:1212-1213` with its
    doubled-index inverses folded in by the caller).
    Returns [F+1, 4, 4].
    """

    def step(cT, T):
        nT = cT @ se3.inverse(T)
        return nT, nT

    T0 = jnp.eye(4, dtype=zetas.dtype)
    _, traj = jax.lax.scan(step, T0, zetas)
    return jnp.concatenate([T0[None], traj], axis=0)


def stereo_left_trajectory(zetas: jnp.ndarray) -> jnp.ndarray:
    """Left-camera trajectory from the doubled (rig, cross) zeta chain.

    The composed L_k -> L_{k+1} motion is cross_k @ rig_k (first L->R, then
    R->L'); the reference composes the same product at `kitti_ba.cpp:1212`.
    zetas: [2*S, 4, 4] alternating (rig, cross). Returns [S+1, 4, 4].
    """
    rig = zetas[0::2]
    cross = zetas[1::2]
    LtoL = jnp.einsum("sij,sjk->sik", cross, rig)
    return trajectory_from_zetas(LtoL)


def propagate_scale(
    zetas: jnp.ndarray, scales: jnp.ndarray | None = None
) -> jnp.ndarray:
    """Apply external per-zeta translation magnitudes (monocular scale).

    Monocular VO is scale-blind per window; the reference injects GT scale
    per frame (`kitti_E.cpp:218-223`). Given ``scales`` [F] (e.g. from GT or
    an odometer), set each zeta's |t|.

    With ``scales=None`` this is the identity: the joint LM solve recovers
    the *relative* scales within each window (the skip constraint couples
    consecutive zetas), and destroying them by unit-normalizing — as an
    earlier revision did — is strictly worse than the reference. Cross-
    window chaining without GT is :func:`boundary_scale_ratio` (the
    reference's scheme, `kitti_ba.cpp:853-870,896-903`, re-derived through
    shared structure).
    """
    if scales is None:
        return zetas
    t = zetas[:, :3, 3]
    norms = jnp.linalg.norm(t, axis=-1, keepdims=True) + 1e-12
    new_t = (t / norms) * scales[:, None]
    return zetas.at[:, :3, 3].set(new_t)


def boundary_scale_ratio(
    T_prev: jnp.ndarray,
    T_next: jnp.ndarray,
    p_back: jnp.ndarray,
    pt_back: jnp.ndarray,
    mask_back: jnp.ndarray,
    p_fwd: jnp.ndarray,
    pt_fwd: jnp.ndarray,
    mask_fwd: jnp.ndarray,
    min_common: int = 4,
) -> float:
    """Scale factor expressing window w+1's units in window w's units.

    At a boundary frame b shared by consecutive windows, the SAME source
    keypoints (FAST detection on frame b is deterministic) are tracked
    backward to b-1 and forward to b+1, so the landmark depths in frame b
    can be computed twice: through T_back = inv(T_prev) (T_prev = zeta
    b-1 -> b in window-w units) and through T_next (zeta b -> b+1 in
    window-w+1 units). Both are depths of the same physical landmarks, so

        s = median(d_back / d_fwd)

    rescales window w+1 into window w's units. This is the reference's
    cross-window scale propagation (`kitti_ba.cpp:853-870,896-903`) made
    explicit via shared structure instead of its boundary-|t| bookkeeping.

    Rows of (p_back, pt_back) and (p_fwd, pt_fwd) must be aligned on the
    same source keypoints of frame b. Host-side (runs once per boundary).
    """
    from epivo_tpu.geometry import epipolar as _epi, se3 as _se3

    T_back = _se3.inverse(jnp.asarray(T_prev))
    d_back, v_back = _epi.epipolar_depth(
        T_back[:3, :3], T_back[:3, 3], jnp.asarray(p_back), jnp.asarray(pt_back)
    )
    T_next = jnp.asarray(T_next)
    d_fwd, v_fwd = _epi.epipolar_depth(
        T_next[:3, :3], T_next[:3, 3], jnp.asarray(p_fwd), jnp.asarray(pt_fwd)
    )
    d_b = np.asarray(d_back)
    d_f = np.asarray(d_fwd)
    both = (
        np.asarray(v_back) & np.asarray(v_fwd)
        & np.asarray(mask_back) & np.asarray(mask_fwd)
        & (d_b > 1e-3) & (d_b < 1e4) & (d_f > 1e-3) & (d_f < 1e4)
    )
    if both.sum() < min_common:
        return 1.0
    return float(np.median(d_b[both] / d_f[both]))
