"""End-to-end two-view VO on a rendered synthetic scene.

Drives the full public pipeline the way a user would — images in, relative
pose out:

  render two views of a random 3D point scene
  -> FAST detection (epivo_tpu.frontend.fast)
  -> pyramidal KLT tracking (epivo_tpu.frontend.klt)
  -> batched RANSAC essential estimation (epivo_tpu.ransac)
  -> cheirality-checked pose recovery (epivo_tpu.geometry.essential)
  -> LM pose refinement (epivo_tpu.optim.lm)
  -> report rotation / translation-direction error against ground truth.

Run:  python examples/synthetic_vo_demo.py [--flat] [--platform cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

parser = argparse.ArgumentParser()
parser.add_argument("--flat", action="store_true",
                    help="feed textureless images (degenerate-path probe)")
parser.add_argument("--platform", default=None, help="cpu|cuda (default: env)")
parser.add_argument("--orb", action="store_true",
                    help="use ORB descriptor matching instead of KLT")
args = parser.parse_args()
if args.platform:
    os.environ["JAX_PLATFORMS"] = args.platform

import jax
if args.platform:
    jax.config.update("jax_platforms", args.platform)
from epivo_tpu.utils import compile_cache

compile_cache.enable()
import jax.numpy as jnp
import numpy as np

from epivo_tpu import ransac
from epivo_tpu.datasets import synthetic
from epivo_tpu.frontend import fast, klt
from epivo_tpu.geometry import camera, essential, se3
from epivo_tpu.optim import lm


def render(points_3d, K, T, H, W, sigma=1.5):
    """Render 3D points as Gaussian blobs seen from pose T (world=cam0)."""
    R, t = se3.matrix_to_rt(T)
    Xc = points_3d @ R.T + t
    uv = (Xc / Xc[:, 2:3]) @ K.T
    yy, xx = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing="ij")
    img = jnp.zeros((H, W), jnp.float32)
    for i in range(uv.shape[0]):
        u, v = uv[i, 0], uv[i, 1]
        img += 255.0 * jnp.exp(-((xx - u) ** 2 + (yy - v) ** 2) / (2 * sigma**2))
    return jnp.clip(img, 0, 255)


def main():
    H, W = 240, 320
    cam = camera.Pinhole(fx=300.0, fy=300.0, cx=W / 2, cy=H / 2, width=W, height=H)
    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)

    # Scene: points 8-20m deep in front of camera 0.
    N_pts = 160
    z = jax.random.uniform(k1, (N_pts,), minval=8.0, maxval=20.0)
    xy = jax.random.uniform(k2, (N_pts, 2), minval=-0.45, maxval=0.45) * z[:, None]
    X = jnp.concatenate([xy, z[:, None]], axis=-1)

    # GT motion: modest rotation + forward-dominant translation.
    xi = jnp.array([0.08, -0.05, 0.6, 0.015, -0.02, 0.01])
    T_gt = se3.se3_exp(xi)
    R_gt, t_gt = se3.matrix_to_rt(T_gt)

    if args.flat:
        img0 = jnp.full((H, W), 90.0)
        img1 = jnp.full((H, W), 90.0)
    else:
        img0 = render(X, cam.K(), se3.identity(), H, W)
        img1 = render(X, cam.K(), T_gt, H, W)

    if args.orb:
        from epivo_tpu.pipeline import vo as vo_mod
        from epivo_tpu.pipeline.config import (FrontendConfig, LMConfig,
                                               RansacConfig, VOConfig)
        cfg = VOConfig(camera=cam,
                       frontend=FrontendConfig(fast_threshold=15.0,
                                               max_keypoints=256),
                       ransac=RansacConfig(n_hyp=512),
                       lm=LMConfig(n_points=48, revert_r_norm=1e-4))
        res = vo_mod.vo_step_orb(img0, img1, k3, cfg)
        print(f"ORB path: {int(res.n_tracked)} matches, "
              f"{int(res.n_inliers)} inliers")
        rot_err = float(jnp.linalg.norm(res.T[:3, :3] - R_gt))
        t_dir = res.T[:3, 3] / (jnp.linalg.norm(res.T[:3, 3]) + 1e-12)
        t_gt_dir = t_gt / jnp.linalg.norm(t_gt)
        dir_err = float(jnp.linalg.norm(t_dir - t_gt_dir))
        print(f"ORB-pose: |R-R_gt|={rot_err:.5f}  |t_dir err|={dir_err:.5f}")
        # Descriptor matches are pixel-quantized (no subpixel refinement),
        # so the translation direction is coarser than the KLT path —
        # matching the reference, where the ORB path trades accuracy for
        # large-motion robustness.
        ok = rot_err < 0.05 and dir_err < 0.3
        print(f"RESULT ok={ok}")
        sys.exit(0 if ok else 1)

    t0 = time.time()
    kp = fast.detect(img0, threshold=15.0, max_keypoints=256)
    n_det = int(jnp.sum(kp.valid))
    print(f"FAST: {n_det} keypoints (budget {kp.xy.shape[0]})")

    flow = klt.track(img0, img1, kp.xy, valid=kp.valid, levels=3)
    n_trk = int(jnp.sum(flow.status))
    print(f"KLT: {n_trk} tracked")

    if n_trk < 16:
        print("DEGENERATE: too few tracks — emitting fallback pose")
        R_fb, t_fb = essential.pose_fallback(jnp.eye(3), jnp.zeros(3))
        print("fallback R=I, t=", np.asarray(t_fb))
        print("RESULT ok=degenerate-handled")
        return

    p0 = camera.normalize(kp.xy, cam.K_inv())
    p1 = camera.normalize(flow.xy, cam.K_inv())

    res = ransac.ransac_essential(
        k3, p0, p1, n_hyp=512, threshold=(1.0 / cam.fx) ** 2,
        mask=flow.status, method="ransac",
    )
    print(f"RANSAC: {int(res.n_inliers)} inliers")

    R_hat, t_hat, front = essential.recover_pose(res.E, p0, p1, mask=res.inliers)
    R_hat, t_hat = essential.pose_fallback(R_hat, t_hat)

    # LM refinement on the top-48 cheirality-passing inliers (kitti_E config).
    sel_mask = res.inliers & front
    order = jnp.argsort(~sel_mask)  # valid first
    take = order[:48]
    pr = p0[take][None]
    p_r = p1[take][None]
    pmask = sel_mask[take][None]
    T0 = se3.rt_to_matrix(R_hat, t_hat)[None]
    out = lm.solve(T0, np.array([[0, 0]], np.int32), pr, p_r, pmask=pmask,
                   huber_delta=1e-5)
    T_ref = out.T0s[0]
    dt = time.time() - t0

    def report(name, R, t):
        rot_err = float(jnp.linalg.norm(R - R_gt))
        t_dir = t / (jnp.linalg.norm(t) + 1e-12)
        t_gt_dir = t_gt / jnp.linalg.norm(t_gt)
        dir_err = float(jnp.linalg.norm(t_dir - t_gt_dir))
        print(f"{name}: |R-R_gt|={rot_err:.5f}  |t_dir err|={dir_err:.5f}")
        return rot_err, dir_err

    re1, de1 = report("E-pose ", R_hat, t_hat)
    re2, de2 = report("LM-pose", T_ref[:3, :3], T_ref[:3, 3])
    print(f"wall: {dt:.2f}s  residual norm: {float(out.r_norm):.3e}")

    ok = re2 < 0.02 and de2 < 0.05
    print(f"RESULT ok={ok}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
