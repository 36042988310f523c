"""Produce the committed ATE artifact: long KITTI-sized runs on the
photometrically realistic corridor fixture (real chip).

VERDICT r1 item 10 / r2 missing #2: no KITTI/EuRoC data ships on the
bench box, so the accuracy evidence beyond blobs is this fixture
(texture, occlusion, exposure drift, sensor noise — see
epivo_tpu/datasets/photoreal.py). Two runs:

1. VO with per-step GT scale (the reference's kitti_E protocol,
   `kitti_E.cpp:218-223`): SE(3)-aligned ATE.
2. Windowed BA with NO ground truth at all — monocular scale recovered by
   the shared-structure depth-ratio chain (ref scheme
   `kitti_ba.cpp:853-870,896-903`): Sim(3)-aligned ATE (standard for
   scale-free monocular evaluation) plus the recovered-vs-true scale
   ratio, evaluated through a streamed frame generator (bounded RSS).

Writes ATE_photoreal.json at the repo root; commit it.

Usage: python scripts/run_photoreal_ate.py [--frames N] [--cpu] [--skip-ba]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--skip-ba", action="store_true")
    ap.add_argument("--skip-vo", action="store_true",
                    help="keep the existing artifact's VO block")
    ap.add_argument("--skip-global", action="store_true",
                    help="skip the global-BA polish comparison run")
    ap.add_argument("--ba-seeds", type=str, default="0",
                    help="comma list; >1 seeds quantifies the no-GT "
                         "chain's run-to-run realization variance")
    ap.add_argument("--skip-ba-base", action="store_true",
                    help="keep the existing artifact's base ba_no_gt* "
                         "blocks (only run what other flags request)")
    ap.add_argument("--global-seeds", type=str, default="",
                    help="comma list: run the global-BA polish at these "
                         "extraction seeds (tags ba_no_gt_global[_seedN]) "
                         "— PAIRED against the same-seed base runs, the "
                         "on/off delta is then same-conditions, not "
                         "across-seed noise")
    ap.add_argument("--collision-free", action="store_true",
                    help="extra no-GT run with the back wall beyond the "
                         "trajectory end (no wall collision)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--pipeline-depth", type=int, default=2)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from epivo_tpu.utils import compile_cache

    compile_cache.enable()

    from epivo_tpu.datasets import photoreal
    from epivo_tpu.geometry import camera
    from epivo_tpu.pipeline import runners
    from epivo_tpu.pipeline.config import (
        FrontendConfig, LMConfig, RansacConfig, VOConfig,
    )

    H, W = 376, 1241  # KITTI-sized
    cam = camera.KITTI_00
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    frames, gt, _ = photoreal.corridor_sequence(
        args.frames, H=H, W=W, K=K, speed=0.8, exposure_drift=0.15,
        noise_sigma=2.0, seed=7)
    cfg = VOConfig(
        camera=cam,
        frontend=FrontendConfig(fast_threshold=30.0, max_keypoints=512,
                                klt_levels=4),
        ransac=RansacConfig(n_hyp=512),
        lm=LMConfig(n_points=48),
    )
    length = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0),
                                         axis=-1)))
    art_path = os.path.join(REPO, "ATE_photoreal.json")
    if args.skip_vo and os.path.exists(art_path):
        vo_block = json.load(open(art_path)).get("vo_gt_scale")
    else:
        t0 = time.time()
        res = runners.run_vo_sequence(frames, cfg, gt_poses=gt,
                                      batch=args.batch, collect_cloud=False,
                                      pipeline_depth=args.pipeline_depth)
        vo_block = {
            "ate_rmse_m": round(float(res.ate), 4),
            "ate_pct_of_length": round(100.0 * float(res.ate) / length, 3),
            "rpe_t_m": round(float(res.rpe_t), 4),
            "inliers_mean": float(res.per_frame["n_inliers"].mean()),
            "reverted_frames": int(res.per_frame["reverted"].sum()),
            "wall_s_total": round(time.time() - t0, 1),
        }
    # Merge-update: keep every block of the existing artifact that this
    # invocation does not re-run (partial re-runs stay self-consistent).
    out = {}
    if os.path.exists(art_path):
        out = json.load(open(art_path))
    out.update({
        "fixture": "photoreal corridor (texture+occlusion+exposure drift"
                   "+sensor noise)",
        "frames": args.frames,
        "image": [H, W],
        "trajectory_length_m": round(length, 2),
        "platform": jax.devices()[0].platform,
        # Self-describing run config (VERDICT r3 weak #3): wall times here
        # INCLUDE host-side frame rendering of the fixture (unlike
        # RUNNER_BENCH.json, which pre-renders frames and times only the
        # pipeline — that is the number to compare against device rate).
        "config": {
            "batch": args.batch, "pipeline_depth": args.pipeline_depth,
            "fast_threshold": 30.0, "max_keypoints": 512, "n_hyp": 512,
            "wall_includes_render": True,
        },
        "vo_gt_scale": vo_block,
    })

    if not args.skip_ba:
        from epivo_tpu.eval import metrics as ev
        from epivo_tpu.pipeline.config import BAConfig, GlobalBAConfig

        def ba_run(tag, gba, seed=0, scene=None):
            ba_cfg = BAConfig(
                camera=cam, frontend=cfg.frontend, ransac=cfg.ransac,
                lm=LMConfig(n_points=32, revert_r_norm=1e-2),
                global_ba=gba,
            )
            # Fresh streamed generator: no GT in the estimation path.
            kw = {} if scene is None else {"scene": scene}
            frames2, _, _ = photoreal.corridor_sequence(
                args.frames, H=H, W=W, K=K, speed=0.8, exposure_drift=0.15,
                noise_sigma=2.0, seed=7, **kw)
            t0 = time.time()
            res_ba = runners.run_ba_sequence(
                frames2, ba_cfg, gt_poses=None, n_frames=args.frames,
                seed=seed, batch=args.batch,
                pipeline_depth=args.pipeline_depth)
            wall_ba = time.time() - t0
            traj = res_ba.trajectory
            gt_aln = np.linalg.inv(gt[0])[None] @ gt[: traj.shape[0]]
            ate_sim3 = ev.ate_rmse(traj, gt_aln, align=True, with_scale=True)
            ate_se3 = ev.ate_rmse(traj, gt_aln, align=True, with_scale=False)
            est_step = np.linalg.norm(np.diff(traj[:, :3, 3], axis=0),
                                      axis=-1)
            gt_step = np.linalg.norm(
                np.diff(gt_aln[: traj.shape[0], :3, 3], axis=0), axis=-1)
            # Monocular no-GT scale has an unobservable GLOBAL gauge (the
            # chain's unit is its first step); fix the gauge on step 0 and
            # report the remaining length ratio — the cumulative RELATIVE
            # scale drift, which IS observable. (The raw est/gt ratio also
            # contains the arbitrary 1/|gt_step0| unit factor; earlier
            # rounds' "recovered_over_true_length" mixed the two.)
            g0 = gt_step[0] / max(est_step[0], 1e-12)
            out[tag] = {
                "ate_sim3_rmse_m": round(float(ate_sim3), 4),
                "ate_sim3_pct_of_length":
                    round(100.0 * float(ate_sim3) / length, 3),
                "ate_se3_rmse_m": round(float(ate_se3), 4),
                "length_ratio_gauge0":
                    round(float(est_step.sum() * g0 / gt_step.sum()), 4),
                "windows_reverted":
                    int(res_ba.per_frame["window_reverted"].sum()),
                "windows_total":
                    int(res_ba.per_frame["window_reverted"].size),
                "wall_s_total": round(wall_ba, 1),
            }

        seeds = [int(x) for x in args.ba_seeds.split(",")]
        if not args.skip_ba_base:
            for s in seeds:
                tag = "ba_no_gt" if s == seeds[0] else "ba_no_gt_seed%d" % s
                ba_run(tag, GlobalBAConfig(enabled=False), seed=s)
        if len(seeds) > 1 and not args.skip_ba_base:
            # The no-GT chain's realization varies run to run: the late
            # corridor section (the camera reaches the fixture's back
            # wall) puts several boundaries in a near-chaotic regime, so
            # RANSAC draw changes (seed, or a recompilation changing
            # f32 rounding at near-ties) move the sim3 ATE by percents of
            # length. Report the spread rather than one lucky draw.
            vals = [out[t]["ate_sim3_pct_of_length"]
                    for t in out if t.startswith("ba_no_gt")]
            out["ba_no_gt_seed_spread_pct"] = [min(vals), max(vals)]
        if args.collision_free:
            # The legacy scene's back wall sits at z=220 while a 300-frame
            # run travels 240 m: the camera drives THROUGH it and the last
            # ~40 frames are geometric garbage. This block measures the
            # SAME course with the wall pushed beyond the trajectory —
            # the collision-free accuracy (GT course itself unchanged:
            # corridor_sequence's gt does not depend on the scene).
            from epivo_tpu.datasets.photoreal import CorridorScene

            ba_run("ba_no_gt_collision_free", GlobalBAConfig(enabled=False),
                   scene=CorridorScene(back_z=float(args.frames) * 0.9 + 60))
        if args.global_seeds:
            # Paired on/off evidence (VERDICT r4 next #4): same seed,
            # same fixture, only the polish stage differs.
            for s in (int(x) for x in args.global_seeds.split(",")):
                tag = ("ba_no_gt_global" if s == 0
                       else "ba_no_gt_global_seed%d" % s)
                ba_run(tag, GlobalBAConfig(enabled=True), seed=s)
            deltas = {}
            for s in range(16):  # every seed with BOTH blocks present
                base = "ba_no_gt" if s == 0 else "ba_no_gt_seed%d" % s
                gtag = ("ba_no_gt_global" if s == 0
                        else "ba_no_gt_global_seed%d" % s)
                if base in out and gtag in out:
                    deltas["seed%d" % s] = round(
                        out[gtag]["ate_sim3_pct_of_length"]
                        - out[base]["ate_sim3_pct_of_length"], 3)
            out["global_ba_paired_delta_pct"] = deltas
        elif not args.skip_global:
            # Global full-trajectory polish (VERDICT r3 missing #3): one
            # joint LM over the complete consecutive+skip constraint graph.
            ba_run("ba_no_gt_global", GlobalBAConfig(enabled=True))

    with open(os.path.join(REPO, "ATE_photoreal.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
