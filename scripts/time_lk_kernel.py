"""Time the fused LK kernel against the XLA scan on the GPU.

Three measurements at the bench's shapes (K=512 keypoints, 21x21 window):

1. the LK loop alone at one pyramid level, 30 and 12 iterations (the
   bench configuration's), search windows S=34 and S=46;
2. ``vo_step`` end to end at B=1 (latency mode);
3. ``vo_step`` vmapped at B=8 (batched mode).

For (2) and (3) the two variants are timed in turns (scan, kernel,
kernel, scan) and the median of each is printed. Results go to stdout and
to the JSON file ``--out`` names. The frames and the VO configuration are
``chip_smoke.py``'s, so the end-to-end numbers match its ``vo_step``.

Usage:  python scripts/time_lk_kernel.py [--out out/lk_kernel.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from epivo_tpu.frontend import fast, klt  # noqa: E402
from epivo_tpu.pipeline import vo  # noqa: E402
from epivo_tpu.utils import compile_cache  # noqa: E402
from epivo_tpu.utils.gpu import (  # noqa: E402
    card_info, lk_loop, median_ms, require_gpu,
)


def level_inputs(img0, img1, S, K=512, win=21, seed=0):
    """LK-loop operands at full resolution for K FAST keypoints."""
    kp = fast.detect(jnp.asarray(img0), 40.0, K)
    pts = kp.xy
    src_wins, o_s = klt._extract_windows(jnp.asarray(img0), pts, S)
    gx, gy = klt._grad_batch(src_wins)
    hi = S - win - 1 - 1e-3
    q_s = jnp.clip(pts - o_s - (win - 1) / 2.0, 0.0, hi)
    lanes = lambda w: jnp.transpose(w, (1, 2, 0))
    T, Ix, Iy = (klt._sample_lanes(lanes(w), q_s, win)
                 for w in (src_wins, gx, gy))
    g = pts + jnp.asarray(np.random.default_rng(seed).normal(
        0, 1.0, pts.shape).astype(np.float32))
    o_t = klt._window_origins(img1.shape, g, S)
    q0 = jnp.clip(g - o_t - (win - 1) / 2.0, 0.0, hi)
    return jnp.asarray(img1), o_t, T, Ix, Iy, q0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "out",
                                                  "lk_kernel.json"))
    opts = ap.parse_args()
    cache = compile_cache.enable()
    dev = require_gpu(1)[0]
    card = card_info()
    print(f"device {dev.device_kind}; card {card}; cache {cache}",
          flush=True)
    frames, _ = cs.render_corridor(2)
    img0, img1 = frames
    out = {"card": card, "device_kind": dev.device_kind,
           "loop_alone_ms": {}, "vo_step_ms": {}}
    eps = 0.01

    for S, iters in ((34, 30), (46, 30), (34, 12), (46, 12)):
        args = level_inputs(img0, img1, S)
        scan = jax.jit(lambda *a, S=S, it=iters: klt._lk_iterate_scan(
            *a, S, it, eps))
        kern = jax.jit(lambda *a, S=S, it=iters: klt._lk_iterate_kernel(
            *a, S, it, eps))
        q_s, _ = scan(*args)
        q_k, _ = kern(*args)
        res = {"scan": median_ms(scan, *args, reps=30),
               "kernel": median_ms(kern, *args, reps=30),
               "max_dq": float(np.abs(np.asarray(q_k) - np.asarray(q_s))
                               .max())}
        out["loop_alone_ms"][f"S{S}_it{iters}"] = res
        print(f"LK loop alone S={S} iters={iters}: {json.dumps(res)}",
              flush=True)

    cfg = cs.bench_vo_config()
    key = jax.random.PRNGKey(0)
    B = cs.BENCH_BATCH

    def single():
        return jax.jit(lambda a, b, k: vo.vo_step(a, b, k, cfg))

    def batched():
        return jax.jit(jax.vmap(lambda a, b, k: vo.vo_step(a, b, k, cfg)))

    inputs = {
        "b1": (single, (img0, img1, key)),
        f"b{B}": (batched, (np.stack([img0] * B), np.stack([img1] * B),
                            jax.random.split(key, B))),
    }
    for name, (make, args) in inputs.items():
        args = jax.device_put(args, dev)
        # vo_step is itself jitted, and JAX reuses a function's first trace:
        # each variant is compiled ahead of time, with the trace caches
        # cleared in between.
        compiled = {}
        for variant in ("scan", "kernel"):
            jax.clear_caches()
            ctx = (lk_loop(klt._lk_iterate_scan) if variant == "scan"
                   else contextlib.nullcontext())
            with ctx:
                lowered = make().lower(*args)
            n = lowered.as_text().count("klt_lk_iterate")
            print(f"vo_step {name} {variant}: {n} LK kernel call sites",
                  flush=True)
            assert (n > 0) == (variant == "kernel"), (name, variant, n)
            compiled[variant] = lowered.compile()
        f_scan, f_kern = compiled["scan"], compiled["kernel"]
        ts = {"scan": [], "kernel": []}
        for variant in ("scan", "kernel", "kernel", "scan"):
            fn = f_scan if variant == "scan" else f_kern
            ts[variant].append(median_ms(fn, *args, reps=20))
        res = {k: float(np.median(v)) for k, v in ts.items()}
        res["runs"] = ts
        out["vo_step_ms"][name] = res
        print(f"vo_step {name}: {json.dumps(res)}", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
