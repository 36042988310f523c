"""Reference-class baseline: the kitti_E workload in the reference's own
execution model (OpenCV C++ kernels + native LM, ONE CPU core).

The reference (`/root/reference/kitti_E.cpp:54-255`) publishes no numbers,
so this script produces them: per frame pair it runs exactly the
reference's stage chain with the same libraries/configs —

    FAST(threshold=40)                  `kitti_E.cpp:71-74`
    calcOpticalFlowPyrLK (21x21, lvl 3) `kitti_E.cpp:82-87`
    findEssentialMat LMEDS prob=0.99    `kitti_E.cpp:98-104`
    recoverPose + cheirality mask       `kitti_E.cpp:120,174-186`
    48-pt single-pose LM refine (30 it) `kitti_E.cpp:170-196`
    closed-form triangulation           `kitti_E.cpp:235-254`

The LM step runs in native C++ (`epivo_tpu/runtime/lm_ref.cpp`, an
independent implementation of the dissertation math) so the baseline pays
Eigen-class native cost for the optimizer, not Python cost. Deliberately
GENEROUS simplifications: only the strongest 512 FAST corners are tracked
(the reference tracks every corner — typically thousands on KITTI frames),
and triangulation is vectorized NumPy rather than a per-point loop. Both
make the baseline FASTER, so vs_baseline comparisons are conservative.

Run pinned to one core (the reference's model):
    taskset -c 0 python baselines/cv2_kitti_e.py
Prints one JSON line: {"cv2_fps": ..., "n_frames": ..., ...}.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_WARMUP = 2
N_ITERS = 30


def run_pair(cv2, img0_u8, img1_u8, K, K_inv, lm_refine):
    """One kitti_E-equivalent frame-pair step. Returns (T, n_cloud)."""
    det = cv2.FastFeatureDetector_create(40, nonmaxSuppression=True)
    kps = det.detect(img0_u8, None)
    if len(kps) < 16:
        return np.eye(4), 0
    kps = sorted(kps, key=lambda k: -k.response)[:512]
    pts0 = np.array([k.pt for k in kps], np.float32).reshape(-1, 1, 2)

    pts1, st, _ = cv2.calcOpticalFlowPyrLK(
        img0_u8, img1_u8, pts0, None, winSize=(21, 21), maxLevel=3,
        criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 30, 0.01),
    )
    good = st.reshape(-1) == 1
    q0 = pts0.reshape(-1, 2)[good]
    q1 = pts1.reshape(-1, 2)[good]
    if q0.shape[0] < 8:
        return np.eye(4), 0

    E, mask = cv2.findEssentialMat(q0, q1, K, method=cv2.LMEDS, prob=0.99)
    if E is None or E.shape[0] < 3:
        return np.eye(4), 0
    E = E[:3]
    _, R, t, mask2 = cv2.recoverPose(E, q0, q1, K, mask=mask.copy())

    # Degenerate fallback (ref `kitti_E.cpp:128-135`).
    if np.trace(R) < 2.7:
        R = np.eye(3)
        t = np.array([[0.1], [0.1], [-0.9]])

    # <= 48 cheirality-masked normalized pairs (ref :170-192).
    sel = mask2.reshape(-1) == 255
    h0 = np.concatenate([q0, np.ones((q0.shape[0], 1), np.float32)], 1)
    h1 = np.concatenate([q1, np.ones((q1.shape[0], 1), np.float32)], 1)
    n0 = (h0 @ K_inv.T)[sel][:48]
    n1 = (h1 @ K_inv.T)[sel][:48]

    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t.reshape(-1)
    if n0.shape[0] >= 8:
        T, _ = lm_refine(T, n0.astype(np.float64), n1.astype(np.float64),
                         lambda0=1e-2, max_iters=30, huber_delta=1e-5)

    # Closed-form triangulation of the inlier set (ref :235-254).
    nh0 = (h0 @ K_inv.T)[sel]
    nh1 = (h1 @ K_inv.T)[sel]
    Rf, tf = T[:3, :3], T[:3, 3]
    A = np.stack([tf[0] - nh1[:, 0] * tf[2], tf[1] - nh1[:, 1] * tf[2]], -1)
    Rp = nh0 @ Rf.T
    B = np.stack([Rp[:, 0] - nh1[:, 0] * Rp[:, 2],
                  Rp[:, 1] - nh1[:, 1] * Rp[:, 2]], -1)
    nB = np.linalg.norm(B, axis=-1)
    ok = nB > 1e-2
    d = np.where(ok, np.linalg.norm(A, axis=-1) / np.where(ok, nB, 1.0), 0.0)
    return T, int(((d > 0) & ok).sum())


def main():
    import cv2

    cv2.setNumThreads(1)  # one-core execution model, like the reference
    # Frame rendering stays on the host CPU.
    import jax

    jax.config.update("jax_platforms", "cpu")
    from bench import render_bench_frames
    from epivo_tpu import runtime

    if not runtime.available():
        runtime.build()

    img0, img1, K = render_bench_frames()
    img0_u8 = np.clip(np.asarray(img0), 0, 255).astype(np.uint8)
    img1_u8 = np.clip(np.asarray(img1), 0, 255).astype(np.uint8)
    K = np.asarray(K, np.float64)
    K_inv = np.linalg.inv(K)

    for _ in range(N_WARMUP):
        run_pair(cv2, img0_u8, img1_u8, K, K_inv, runtime.lm_refine_pose)

    t0 = time.perf_counter()
    for _ in range(N_ITERS):
        T, _ = run_pair(cv2, img0_u8, img1_u8, K, K_inv, runtime.lm_refine_pose)
    dt = time.perf_counter() - t0

    print(json.dumps({
        "cv2_fps": N_ITERS / dt,
        "n_frames": N_ITERS,
        "note": "OpenCV C++ frontend + native C++ LM, 1 core, 512-corner "
                "budget (generous vs the reference's unbounded corners)",
    }))


if __name__ == "__main__":
    main()
