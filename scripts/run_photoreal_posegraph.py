"""POSE_GRAPH.json: multi-loop Sim(3) pose-graph evidence on the accelerator.

Runs the full no-GT windowed-BA pipeline ONCE (loop closure off) on a
two-lap photoreal loop course — every lap re-traverses both straights,
so the course carries several true revisits with overlapping spans —
then applies the loop-closure post-stage to the SAME extracted
trajectory in both modes:

- greedy (``LoopConfig.pose_graph=False``, the r4/r5 per-span spread:
  overlapping spans admit one loop each), and
- joint (default: all verified loops reconciled in one Sim(3)
  pose-graph solve, ``pipeline/posegraph.py``).

Applying both modes to one extraction isolates the correction stage —
the comparison is exact, not across stochastic re-runs — and is
faithful to production: loop closure IS a post-stage over the assembled
trajectory (`runners._loop_stage`). No ground truth enters estimation.

Usage: python scripts/run_photoreal_posegraph.py [--cpu] [--half]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--half", action="store_true")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--laps", type=int, default=2)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from epivo_tpu.utils import compile_cache

    compile_cache.enable()

    from epivo_tpu.datasets import photoreal
    from epivo_tpu.eval import metrics as ev
    from epivo_tpu.geometry import camera as cam_mod
    from epivo_tpu.pipeline import loopclose, runners
    from epivo_tpu.pipeline.config import (
        BAConfig, FrontendConfig, LMConfig, LoopConfig, RansacConfig,
    )

    if args.half:
        H, W, f = 188, 620, 359.4
    else:
        H, W, f = 376, 1241, 718.856
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
    cam = cam_mod.Pinhole(f, f, W / 2.0, H / 2.0, W, H)

    frames, gt, _ = photoreal.loop_sequence(H=H, W=W, K=K, laps=args.laps)
    F = len(gt)
    base_loop = LoopConfig(enabled=False)
    cfg = BAConfig(
        camera=cam,
        frontend=FrontendConfig(fast_threshold=30.0, max_keypoints=512,
                                klt_levels=4),
        ransac=RansacConfig(n_hyp=512),
        lm=LMConfig(n_points=32, revert_r_norm=1e-2),
        loop=base_loop,
    )

    # Tee the keyframe store off the frame stream exactly as the runner's
    # loop path does, while the extraction itself runs loop-off.
    kf_store = loopclose.KeyframeStore(base_loop.keyframe_stride,
                                       base_loop.keyframe_budget)

    def teed():
        for idx, fr in enumerate(frames):
            kf_store.offer(idx, fr)
            yield fr

    t0 = time.time()
    res = runners.run_ba_sequence(teed(), cfg, gt_poses=None, n_frames=F,
                                  batch=args.batch, pipeline_depth=2)
    wall_extract = time.time() - t0
    traj_off = res.trajectory

    gt_aln = np.linalg.inv(gt[0])[None] @ gt[: traj_off.shape[0]]
    gt_step = np.linalg.norm(np.diff(gt_aln[:, :3, 3], axis=0), axis=-1)
    length = float(gt_step.sum())

    def evaluate(traj, loops, wall):
        est_step = np.linalg.norm(np.diff(traj[:, :3, 3], axis=0), axis=-1)
        g0 = gt_step[0] / max(est_step[0], 1e-12)
        n = min(len(est_step), len(gt_step))
        ate_sim3 = ev.ate_rmse(traj, gt_aln, align=True, with_scale=True)
        ate_se3 = ev.ate_rmse(traj, gt_aln, align=True, with_scale=False)
        return {
            "ate_sim3_rmse_m": round(float(ate_sim3), 4),
            "ate_sim3_pct_of_length": round(100 * float(ate_sim3) / length, 3),
            "ate_se3_rmse_m": round(float(ate_se3), 4),
            "endpoint_gap_gauge0_m": round(float(np.linalg.norm(
                traj[-1, :3, 3] * g0 - gt_aln[-1, :3, 3])), 4),
            "length_ratio_gauge0": round(
                float(est_step[:n].sum() * g0 / gt_step[:n].sum()), 4),
            "loops_applied": [
                {"i": int(lp.i), "j": int(lp.j), "inliers": int(lp.n_inliers),
                 "retrieval_score": int(lp.score),
                 "sigma": round(float(lp.sigma), 4)}
                for lp in loops
            ],
            "wall_s": round(wall, 1),
        }

    out = {
        "fixture": f"photoreal two-lap loop course (loop_sequence laps="
                   f"{args.laps}): multiple true revisits, overlapping spans",
        "frames": F,
        "image": [H, W],
        "trajectory_length_m": round(length, 2),
        "platform": jax.devices()[0].platform,
        "config": {
            "batch": args.batch, "pipeline_depth": 2,
            "fast_threshold": 30.0, "max_keypoints": 512, "n_hyp": 512,
            "keyframe_stride": kf_store.stride,
            "wall_includes_render": True,
        },
        "loop_off": evaluate(traj_off, [], wall_extract),
    }

    for name, pg in (("loop_greedy", False), ("loop_pose_graph", True)):
        cfg_mode = dataclasses.replace(
            cfg, loop=dataclasses.replace(base_loop, enabled=True,
                                          pose_graph=pg))
        t0 = time.time()
        traj, loops = runners._loop_stage(traj_off, kf_store, cfg_mode,
                                          seed=0, mlog=None)
        out[name] = evaluate(traj, loops, time.time() - t0)

    path = os.path.join(REPO, "POSE_GRAPH.json")
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
