"""End-to-end sequence-runner throughput (VERDICT r2 missing #3 evidence).

``bench.py`` measures the pure device rate of the fused VO step; this
script measures what :func:`runners.run_vo_sequence` actually sustains
end-to-end — host batching, H2D upload, one-deep dispatch pipelining,
D2H fetch, checkpoint-free — over pre-rendered in-memory corridor frames
(render cost excluded: it is fixture generation, not pipeline work; real
deployments decode PNGs through the native loader's background threads).

Writes RUNNER_BENCH.json at the repo root; commit it.

Usage: python scripts/bench_runner.py [--frames N] [--batch B] [--cpu]
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
    ap.add_argument("--frames", type=int, default=129)
    ap.add_argument("--batches", default="8,32,64")
    ap.add_argument("--depths", default="1,2,4")
    ap.add_argument("--repeats", type=int, default=2,
                    help="timed repeats per config; min is reported")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from epivo_tpu.utils import compile_cache

    compile_cache.enable()

    import bench
    from epivo_tpu.datasets import photoreal
    from epivo_tpu.pipeline import runners

    cfg = bench._config()
    H, W = bench.WORKLOAD["image"]
    gen, gt, _ = photoreal.corridor_sequence(args.frames, H=H, W=W, seed=0)
    frames = [np.asarray(f, np.float32) for f in gen]

    device_fps = None
    stages_path = os.path.join(REPO, "bench_stages.json")
    if os.path.exists(stages_path):
        with open(stages_path) as f:
            device_fps = json.load(f).get("batched_fps")

    depths = [int(d) for d in args.depths.split(",")]
    runs = []
    ate = None
    for batch in [int(b) for b in args.batches.split(",")]:
        # Warm run compiles the batched step for this batch size (the
        # jitted step is lru-cached across runner invocations, so the
        # timed runs below reuse the executable).
        runners.run_vo_sequence(frames[: batch + 1], cfg, batch=batch,
                                collect_cloud=False)
        n_dispatch = -(-(len(frames) - 1) // batch)
        for depth in depths:
            walls = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                res = runners.run_vo_sequence(frames, cfg, gt_poses=gt,
                                              batch=batch,
                                              collect_cloud=False,
                                              pipeline_depth=depth)
                walls.append(round(time.perf_counter() - t0, 3))
            wall = min(walls)
            fps = (len(frames) - 1) / wall
            ate = round(float(res.ate), 4) if res.ate is not None else None
            runs.append({
                "batch": batch, "pipeline_depth": depth,
                "end_to_end_fps": round(fps, 2),
                "wall_s_all_repeats": walls,
                "n_dispatches": n_dispatch,
                "s_per_dispatch": round(wall / n_dispatch, 3),
                "fraction_of_device_rate": (
                    round(fps / device_fps, 3) if device_fps else None),
            })
            print(runs[-1], flush=True)

    best = max(runs, key=lambda r: r["end_to_end_fps"])
    out = {
        "runner": "run_vo_sequence",
        "frames": len(frames),
        "runs": runs,
        "best": best,
        "device_batched_fps": device_fps,
        "ate_m": ate,
        "platform": jax.devices()[0].platform,
        # Self-describing config (VERDICT r3 next #8).
        "config": {"image": [H, W], "repeats": args.repeats,
                   "collect_cloud": False,
                   "n_hyp": 512, "max_keypoints": 512, "n_points": 48},
        "note": "pre-rendered in-memory frames; dispatch pipelined "
                "stream.PipelinedDispatch(depth); min of repeats; "
                "s_per_dispatch isolates the per-dispatch cost.",
    }
    with open(os.path.join(REPO, "RUNNER_BENCH.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
