"""Bounded-memory evidence artifact: long full-resolution photoreal STEREO
BA through the streamed runner (VERDICT r2 missing #3/#4 'Done' criteria).

Renders a KITTI-resolution stereo corridor sequence lazily (two
generator passes, nothing materialized), runs the streamed
``run_stereo_ba_sequence`` (bounded FrameStream + pipelined dispatch),
and records metric accuracy plus the process's peak RSS — demonstrating
that a sequence whose decoded frames would occupy
``2 * F * H * W * 4`` bytes (e.g. 500 frames = 1.9 GB; a full KITTI
stereo sequence = ~17 GB) runs in bounded memory.

Writes STEREO_STREAM.json at the repo root; commit it.

Usage: python scripts/run_photoreal_stereo.py [--frames N] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=500)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument("--devices", type=int, default=0,
                    help="shard the window solve over an N-device mesh "
                         "(0 = single device)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from epivo_tpu.utils import compile_cache

    compile_cache.enable()

    mesh = None
    if args.devices:
        from epivo_tpu.parallel import mesh as mesh_mod

        mesh = mesh_mod.make_mesh(n_win=args.devices, n_hyp=1,
                                  devices=jax.devices()[: args.devices])

    from epivo_tpu.datasets import photoreal
    from epivo_tpu.eval import metrics as ev
    from epivo_tpu.geometry.camera import Pinhole
    from epivo_tpu.pipeline import runners
    from epivo_tpu.pipeline.config import (
        BAConfig, FrontendConfig, LMConfig, RansacConfig,
    )

    H, W = 376, 1241
    L, R, gt, K, T_rig = photoreal.corridor_stereo_sequence(
        args.frames, H=H, W=W, seed=3)
    cam = Pinhole(fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]),
                  cy=float(K[1, 2]), width=W, height=H)
    cfg = BAConfig(
        camera=cam,
        frontend=FrontendConfig(fast_threshold=30.0, max_keypoints=512,
                                klt_levels=4),
        ransac=RansacConfig(n_hyp=512),
        lm=LMConfig(n_points=32, revert_r_norm=1e-2),
    )

    rss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.time()
    res = runners.run_stereo_ba_sequence(
        L, R, cfg, T_rig=T_rig, n_frames=args.frames,
        batch=args.batch, pipeline_depth=args.pipeline_depth, mesh=mesh,
    )
    wall = time.time() - t0
    rss_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

    gt_aln = np.linalg.inv(gt[0])[None] @ gt[: res.trajectory.shape[0]]
    n = min(len(gt_aln), res.trajectory.shape[0])
    ate = ev.ate_rmse(res.trajectory[:n], gt_aln[:n], align=True,
                      with_scale=False)  # METRIC: scale from the baseline
    length = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0),
                                         axis=-1)))
    est_len = float(np.sum(np.linalg.norm(
        np.diff(res.trajectory[:, :3, 3], axis=0), axis=-1)))

    decoded_gb = 2 * args.frames * H * W * 4 / 1e9
    out = {
        "fixture": "photoreal stereo corridor",
        "frames": args.frames,
        "image": [H, W],
        "baseline_m": float(-T_rig[0, 3]),
        "decoded_sequence_gb": round(decoded_gb, 2),
        "peak_rss_gb": round(rss_peak / 1e6, 2),  # ru_maxrss is kB on linux
        "rss_before_gb": round(rss_before / 1e6, 2),
        "ate_metric_rmse_m": round(float(ate), 4),
        "ate_pct_of_length": round(100.0 * float(ate) / length, 3),
        "recovered_over_true_length": round(est_len / length, 4),
        "windows_reverted": int(res.per_frame["window_reverted"].sum()),
        "windows_total": int(res.per_frame["window_reverted"].size),
        "wall_s_total": round(wall, 1),
        "platform": jax.devices()[0].platform,
        # Self-describing run config (VERDICT r3 next #8).
        "config": {
            "batch": args.batch, "pipeline_depth": args.pipeline_depth,
            "devices": args.devices or 1,
            "fast_threshold": 30.0, "max_keypoints": 512, "n_hyp": 512,
            "n_points": 32, "scale_refine": True, "post_lm_rescale": True,
        },
        "note": "frames rendered lazily and streamed; peak RSS must stay "
                "far below the decoded sequence size",
    }
    with open(os.path.join(REPO, "STEREO_STREAM.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
