"""Drive the sequence runners end-to-end on a rendered multi-frame scene.

Exercises the public dataset->runner surface exactly as a KITTI user would:
a frame stream + GT poses in, trajectory/ATE/cloud artifacts out — for both
the two-view VO runner (kitti_E equivalent) and the windowed-BA runner
(kitti_ba mono equivalent). Writes reference-format artifacts + a plot.

Run: python examples/sequence_demo.py [--platform cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import sys

parser = argparse.ArgumentParser()
parser.add_argument("--platform", default=None)
parser.add_argument("--out", default="out/seq_demo")
parser.add_argument("--frames", type=int, default=8)
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

from epivo_tpu.geometry import camera, se3
from epivo_tpu.pipeline import runners
from epivo_tpu.pipeline.config import (
    BAConfig, FrontendConfig, LMConfig, RansacConfig, VOConfig,
)
from epivo_tpu.viz import export


def render(points_3d, K, T, H, W, sigma=1.5):
    R, t = se3.matrix_to_rt(T)
    Xc = points_3d @ R.T + t
    uv = (Xc / Xc[:, 2:3]) @ K.T
    yy, xx = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing="ij")
    img = jnp.zeros((H, W), jnp.float32)
    for i in range(uv.shape[0]):
        img += 255.0 * jnp.exp(
            -((xx - uv[i, 0]) ** 2 + (yy - uv[i, 1]) ** 2) / (2 * sigma**2)
        )
    return jnp.clip(img, 0, 255)


def main():
    H, W = 120, 160
    cam = camera.Pinhole(fx=200.0, fy=200.0, cx=W / 2, cy=H / 2, width=W, height=H)
    cfg = VOConfig(
        camera=cam,
        frontend=FrontendConfig(fast_threshold=15.0, max_keypoints=128,
                                klt_levels=3),
        ransac=RansacConfig(n_hyp=256),
        lm=LMConfig(n_points=32, revert_r_norm=1e-4),
    )

    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    z = jax.random.uniform(k1, (140,), minval=6.0, maxval=18.0)
    xy = jax.random.uniform(k2, (140, 2), minval=-0.7, maxval=0.7) * z[:, None]
    X = jnp.concatenate([xy, z[:, None]], axis=-1)
    step = np.asarray(se3.se3_exp(jnp.array([0.02, -0.01, 0.35, 0.006, -0.01, 0.004])))

    frames, gt = [], []
    T_wc = np.eye(4)
    for _ in range(args.frames):
        frames.append(np.asarray(render(X, cam.K(), jnp.asarray(np.linalg.inv(T_wc)), H, W)))
        gt.append(T_wc)
        T_wc = T_wc @ np.linalg.inv(step)
    gt = np.stack(gt)

    os.makedirs(args.out, exist_ok=True)

    res = runners.run_vo_sequence(frames, cfg, gt_poses=gt, batch=4)
    print(f"VO runner: ATE={res.ate:.4f} m  RPE_t={res.rpe_t:.4f}  "
          f"cloud={res.cloud.shape[0]} pts  "
          f"inliers(min)={res.per_frame['n_inliers'].min()}")

    ba_cfg = BAConfig(camera=cam, frontend=cfg.frontend, ransac=cfg.ransac,
                      lm=LMConfig(n_points=32, revert_r_norm=1e-2))
    res_ba = runners.run_ba_sequence(frames, ba_cfg, gt_poses=gt)
    print(f"BA runner: ATE={res_ba.ate:.4f} m  RPE_t={res_ba.rpe_t:.4f}  "
          f"windows reverted={res_ba.per_frame['window_reverted'].sum()}")

    # Reference-format artifacts + plot.
    export.write_poses(os.path.join(args.out, "kitti.T"), res.trajectory)
    export.write_poses(os.path.join(args.out, "kitti.GT"), res.gt_trajectory)
    export.write_cloud(os.path.join(args.out, "pts.cld"), res.cloud,
                       lims_path=os.path.join(args.out, "lims"),
                       limits=res.cloud_limits)
    export.plot_trajectories(
        os.path.join(args.out, "traj.png"),
        {"VO": res.trajectory, "BA": res_ba.trajectory, "GT": res.gt_trajectory},
        cloud=res.cloud,
    )
    print(f"artifacts -> {args.out}: "
          + ", ".join(sorted(os.listdir(args.out))))

    ok = res.ate < 0.1 and res_ba.ate < 0.15
    print(f"RESULT ok={ok}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
