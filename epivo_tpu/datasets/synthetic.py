"""Synthetic SE(3) scene/sequence generator — the permanent test fixture.

Re-design of the reference's test harness `sequence.hpp`
(`gen_T:10-29`, `gen_sequence:31-37`, `T_noise:39-50`, `noise_sequence:52-62`,
`gen_points:64-104`, `gen_scene_sequence:106-159`): random bounded-rotation
pose chains, calibrated perturbations, and visible-point sampling with known
ground truth, used for GT-recovery property tests of the optimizer.

Differences from the reference (deliberate, for static shapes):
- ``jax.random`` PRNG keys instead of ``rand()`` — reproducible, parallel.
- The reference rejection-samples points until the target-frame depth
  exceeds 10 (`sequence.hpp:83-90`). Rejection loops are data-dependent
  control flow; we instead sample depths directly in a guaranteed-visible
  band and construct points from target-frame geometry, which produces the
  same distributional properties (positive, bounded depth in both frames)
  with fixed shapes.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from epivo_tpu.geometry import se3


class SceneSequence(NamedTuple):
    """A synthetic multi-reprojection scene with ground truth.

    Mirrors the outputs of `gen_scene_sequence` (`sequence.hpp:106-159`).
    """

    Ts: jnp.ndarray  # [Z, 4, 4] ground-truth zeta poses (frame j -> j+1)
    T0s: jnp.ndarray  # [Z, 4, 4] perturbed initialization
    reps: np.ndarray  # [R, 2] (z0, z1) zeta spans (static metadata)
    p: jnp.ndarray  # [R, N, 3] source points (normalized homogeneous)
    p_t: jnp.ndarray  # [R, N, 3] target points
    X: jnp.ndarray  # [R, N, 3] landmark positions in the source frame


def random_pose(key, max_angle: float = np.pi / 6, t_scale: float = 2.0,
                dtype=jnp.float32) -> jnp.ndarray:
    """One random pose: per-axis rotations bounded by ``max_angle``,
    translation in [-s, s]^3 with positive z (ref `gen_T`, `sequence.hpp:10-29`)."""
    k1, k2 = jax.random.split(key)
    angles = jax.random.uniform(k1, (3,), dtype, -max_angle, max_angle)
    Rx = se3.so3_exp(jnp.array([angles[0], 0, 0], dtype))
    Ry = se3.so3_exp(jnp.array([0, angles[1], 0], dtype))
    Rz = se3.so3_exp(jnp.array([0, 0, angles[2]], dtype))
    R = Rx @ Ry @ Rz
    t = jax.random.uniform(k2, (3,), dtype, -t_scale, t_scale)
    t = t.at[2].set(jnp.abs(t[2]))
    return se3.rt_to_matrix(R, t)


def random_sequence(key, n: int, dtype=jnp.float32) -> jnp.ndarray:
    keys = jax.random.split(key, n)
    return jnp.stack([random_pose(k, dtype=dtype) for k in keys])


def perturb_pose(key, T: jnp.ndarray, rot_noise: float = 0.05,
                 t_noise: float = 0.1) -> jnp.ndarray:
    """T @ T_noise with bounded rotation/translation noise
    (ref `T_noise`/`noise_sequence`, `sequence.hpp:39-62`)."""
    dtype = T.dtype
    k1, k2 = jax.random.split(key)
    angles = jax.random.uniform(k1, (3,), dtype, -rot_noise, rot_noise)
    Rx = se3.so3_exp(jnp.array([angles[0], 0, 0], dtype))
    Ry = se3.so3_exp(jnp.array([0, angles[1], 0], dtype))
    Rz = se3.so3_exp(jnp.array([0, 0, angles[2]], dtype))
    tn = jax.random.uniform(k2, (3,), dtype, -t_noise, t_noise)
    Tn = se3.rt_to_matrix(Rx @ Ry @ Rz, tn)
    return T @ Tn


def perturb_sequence(key, Ts: jnp.ndarray, rot_noise: float = 0.05,
                     t_noise: float = 0.1) -> jnp.ndarray:
    keys = jax.random.split(key, Ts.shape[0])
    return jnp.stack(
        [perturb_pose(k, T, rot_noise, t_noise) for k, T in zip(keys, Ts)]
    )


def gen_points(key, N: int, T: jnp.ndarray, depth_range=(12.0, 40.0),
               pixel_noise: float = 0.0):
    """Sample N landmarks visible in both views of relative pose T.

    Replaces the reference's rejection loop (`sequence.hpp:81-91`) with
    direct construction: sample target-frame points with depth in
    ``depth_range`` (all > the reference's z' > 10 gate), lift back to the
    source frame, and keep only those with positive source depth via a
    validity-preserving resample trick (mirror z). Returns
    (X [N,3] source-frame points, p [N,3], p_t [N,3]).
    """
    dtype = T.dtype
    R, t = se3.matrix_to_rt(T)
    k1, k2, k3 = jax.random.split(key, 3)
    # Target-frame construction guarantees z' in depth_range.
    z_t = jax.random.uniform(k1, (N,), dtype, depth_range[0], depth_range[1])
    xy_t = jax.random.uniform(k2, (N, 2), dtype, -0.6, 0.6) * z_t[:, None]
    X_t = jnp.concatenate([xy_t, z_t[:, None]], axis=-1)
    # Back to source frame: X = R^T (X_t - t)
    X = jnp.einsum("ji,nj->ni", R, X_t - t)
    # Ensure positive source depth: flip the target lateral position for
    # points that land behind the source camera (keeps z' unchanged).
    bad = X[:, 2] <= 1e-3
    X_t_flipped = jnp.concatenate([-xy_t, z_t[:, None]], axis=-1)
    X_flip = jnp.einsum("ji,nj->ni", R, X_t_flipped - t)
    X = jnp.where(bad[:, None], X_flip, X)
    X_t = jnp.where(bad[:, None], X_t_flipped, X_t)

    p = X / X[:, 2:3]
    p_t = X_t / X_t[:, 2:3]
    if pixel_noise > 0.0:
        noise = jax.random.normal(k3, (N, 2, 2), dtype) * pixel_noise
        p = p.at[:, :2].add(noise[:, 0])
        p_t = p_t.at[:, :2].add(noise[:, 1])
    return X, p, p_t


def compose_span(Ts: jnp.ndarray, z0: int, z1: int) -> jnp.ndarray:
    """Composed relative pose over a zeta span, forward or reversed
    (ref `gen_scene_sequence`, `sequence.hpp:143-151`)."""
    if z0 <= z1:
        out = jnp.eye(4, dtype=Ts.dtype)
        for j in range(z0, z1 + 1):
            out = Ts[j] @ out
    else:
        out = jnp.eye(4, dtype=Ts.dtype)
        for j in range(z0, z1 - 1, -1):
            out = se3.inverse(Ts[j]) @ out
    return out


def gen_scene_sequence(
    key,
    N: int,
    n_zeta: int,
    reps: Sequence[Tuple[int, int]],
    rot_noise: float = 0.05,
    t_noise: float = 0.1,
    pixel_noise: float = 0.0,
    dtype=jnp.float32,
) -> SceneSequence:
    """Full synthetic scene: GT chain, perturbed init, per-rep point matches."""
    reps = np.asarray(reps, dtype=np.int32).reshape(-1, 2)
    for z0, z1 in reps:
        assert 0 <= z0 < n_zeta and 0 <= z1 < n_zeta
    k_seq, k_noise, k_pts = jax.random.split(key, 3)
    Ts = random_sequence(k_seq, n_zeta, dtype=dtype)
    T0s = perturb_sequence(k_noise, Ts, rot_noise, t_noise)

    Xs, ps, pts = [], [], []
    pkeys = jax.random.split(k_pts, len(reps))
    for (z0, z1), pk in zip(reps, pkeys):
        T = compose_span(Ts, int(z0), int(z1))
        X, p, p_t = gen_points(pk, N, T, pixel_noise=pixel_noise)
        Xs.append(X)
        ps.append(p)
        pts.append(p_t)
    return SceneSequence(
        Ts=Ts,
        T0s=T0s,
        reps=reps,
        p=jnp.stack(ps),
        p_t=jnp.stack(pts),
        X=jnp.stack(Xs),
    )
