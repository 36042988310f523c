"""Reference-class baseline: the windowed-BA solve in the reference's own
execution model — the native multi-zeta LM looped serially on ONE CPU core.

The reference's BA consumer thread solves one ws=3 window at a time
(`/root/reference/kitti_ba.cpp:757-905`: assemble constraints, call
`Levenberg_Marquardt`, revert on high residual). This script replays that
loop over the EXACT window tensors the device bench solves (passed as an npz
produced by `bench.build_ba_workload`), using the native windowed LM
(`epivo_tpu/runtime/lm_ref.cpp::epivo_lm_windowed` — flat arrays, analytic
Jacobians, hand-rolled Cholesky; no Eigen heap traffic, so it is FASTER
than the reference's own implementation and the comparison is
conservative).

Run pinned to one core:
    taskset -c 0 python baselines/native_ba.py bench_ba_workload.npz
Prints one JSON line: {"ba_windows_per_s": ..., "ba_iters_per_s": ...}.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_WARMUP = 1
N_REPS = 3

# LM schedule: must match bench._ba_config (ref `kitti_ba.cpp:1044`,
# `jac_Rt_gen_.cpp:17,323`).
LAMBDA0 = 1e-2
MAX_ITERS = 30
HUBER_DELTA = 1e-5
EPSILON = 1e-8


def solve_all(runtime, data):
    total_iters = 0
    for w in range(data["T0s"].shape[0]):
        _, _, _, iters = runtime.lm_windowed(
            data["T0s"][w], data["reps"], data["p"][w], data["p_t"][w],
            wreps=data["wreps"][w], pmask=data["pmask"][w],
            lambda0=LAMBDA0, max_iters=MAX_ITERS, huber_delta=HUBER_DELTA,
            epsilon=EPSILON,
        )
        total_iters += iters
    return total_iters


def main():
    from epivo_tpu import runtime

    if not runtime.available():
        runtime.build()

    z = np.load(sys.argv[1], allow_pickle=True)
    data = {k: np.asarray(z[k]) for k in
            ("T0s", "p", "p_t", "wreps", "pmask", "reps")}
    W = data["T0s"].shape[0]

    for _ in range(N_WARMUP):
        solve_all(runtime, data)
    best = float("inf")
    iters = 0
    for _ in range(N_REPS):
        t0 = time.perf_counter()
        iters = solve_all(runtime, data)
        best = min(best, time.perf_counter() - t0)

    print(json.dumps({
        "ba_windows_per_s": W / best,
        "ba_iters_per_s": iters / best,
        "n_windows": W,
        "iters_per_pass": iters,
        "note": "native windowed multi-zeta LM, 1 core, serial windows "
                "(no Eigen heap traffic: faster than the reference's own "
                "implementation)",
    }))


if __name__ == "__main__":
    main()
