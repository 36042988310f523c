"""Smoke test of the VO + windowed-BA path on one NVIDIA GPU.

Drives the system through the entry points a user calls, at the size of
its KITTI odometry deployment (mono 376x1241; corridor frames rendered from
a seed with KITTI_00 intrinsics), and checks every device result against a
plain reference. Phases, each fatal:

  device   require a GPU; print its kind, count, name and power limit
  compile  vo_step (single, and vmapped at B=8) and ba_windows (W=512)
  kernels  FAST + NMS and klt.track on the GPU against the CPU; the fused
           LK kernel against the XLA scan on the GPU
  ba       ba_windows (lane-major LM) against the plain LM, and GPU vs CPU
  main     run_vo_sequence and run_ba_sequence over 65 rendered frames

``--four`` runs only the multi-device paths on four cards, each against
its one-card (or unsharded) counterpart. The last line of stdout is one
JSON object; it is printed only when every phase passed.

Usage:
  python chip_smoke.py          # one card
  python chip_smoke.py --four   # four cards
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from epivo_tpu.utils.gpu import card_info, lk_loop, median_ms, require_gpu

HERE = os.path.dirname(os.path.abspath(__file__))
BA_WORKLOAD = os.path.join(HERE, "bench_ba_workload.npz")

# Tolerances, each with its reason. (FAST score map + NMS has none: it is
# elementwise IEEE subtract/min/max/select, so GPU and CPU agree bit for
# bit; see phase_kernels.)
# KLT flow: the LK normal equations sum 441 products per iteration, in a
# different order on each backend, so iterates drift by float32 rounding.
FLOW_MEDIAN_PX = 1e-3      # median |flow_a - flow_b| over points both track
FLOW_CLOSE_PX = 0.05       # ... and at least FLOW_CLOSE_FRAC of them within
FLOW_CLOSE_FRAC = 0.99
STATUS_AGREE_FRAC = 0.99   # tracked/not-tracked decisions that agree
# Windowed BA: the same LM on a different layout or backend; 30 f32 LM
# iterations with different reduction order. Pose bound of the repo's
# 1-vs-N window-solve equality check: every window's rotation, and on
# well-posed windows also its translation directions.
BA_ATOL = 5e-3
# Corridor windows (the bench workload) leave each relative translation's
# length free: the camera moves straight ahead, and pairwise epipolar
# constraints do not fix the scale of collinear translations. Their normal
# matrices are near-singular along that valley, so f32 rounding can stop
# the two solves at different points of it, with different energies in a
# few windows (see phase_ba). Bounds on quantiles of the per-window
# relative r_norm difference (quantile -> bound); on the H100 lanes vs
# plain read 3.4e-6, 5.2e-5, 4.5e-3 and 0.114.
BA_RNORM_BOUNDS = {0.5: 1e-4, 0.9: 1e-3, 0.98: 2e-2, 1.0: 0.25}
# Main path: VO ATE bound of tests/test_photoreal.py (2% of path length).
VO_ATE_FRAC = 0.02
# BA runner on the rendered corridor: 1% of path length, about six times
# the ATE of the first H100 run (0.159%; see CHANGES.md).
BA_ATE_FRAC = 0.01
# Four-card extraction: the population median of per-pair pose deltas
# (a RANSAC near-tie may flip individual pairs under SPMD rounding).
PAIR_MEDIAN_DELTA = 1e-2

KITTI_HW = (376, 1241)
BENCH_BATCH = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def memory_summary(compiled) -> dict:
    m = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {f: int(getattr(m, f)) for f in fields if hasattr(m, f)}


def bench_vo_config(camera=None):
    """The bench's VO configuration (512 keypoints, 512 hypotheses, 48 LM
    points, 4 KLT levels)."""
    from epivo_tpu.geometry import camera as cam
    from epivo_tpu.pipeline.config import (
        FrontendConfig, LMConfig, RansacConfig, VOConfig,
    )

    return VOConfig(
        camera=camera or cam.KITTI_00,
        frontend=FrontendConfig(fast_threshold=40.0, max_keypoints=512,
                                klt_levels=4),
        ransac=RansacConfig(n_hyp=512),
        lm=LMConfig(n_points=48),
    )


def bench_ba_config():
    """The bench's windowed-BA configuration (ws=3, 32 points, 30 iters)."""
    from epivo_tpu.geometry import camera as cam
    from epivo_tpu.pipeline.config import BAConfig, LMConfig

    return BAConfig(camera=cam.KITTI_00,
                    lm=LMConfig(n_points=32, max_iters=30,
                                revert_r_norm=1e-2))


def load_ba_workload(n_windows: int | None = None) -> dict:
    """The committed bench BA workload: W=512 ws=3 windows of constraints
    extracted from a corridor sequence."""
    z = np.load(BA_WORKLOAD, allow_pickle=True)
    keys = ("T0s", "p", "p_t", "wreps", "pmask")
    return {k: z[k][:n_windows] for k in keys}


def render_corridor(n_frames: int, hw=KITTI_HW, camera=None, seed: int = 0):
    """Seeded corridor frames (list of float32 [H, W]) and GT poses."""
    from epivo_tpu.datasets import photoreal
    from epivo_tpu.geometry import camera as cam

    camera = camera or cam.KITTI_00
    frames, gt, _ = photoreal.corridor_sequence(
        n_frames, H=hw[0], W=hw[1], K=np.asarray(camera.K()), seed=seed)
    return [np.asarray(f, np.float32) for f in frames], np.asarray(gt)


# --------------------------------------------------------------------------
# One-card phases
# --------------------------------------------------------------------------

def phase_compile(cfg, img0, img1, ba_data, ba_cfg, device,
                  batch: int = BENCH_BATCH) -> dict:
    """Compile vo_step (single and vmapped) and ba_windows; print each
    step's compile seconds and memory analysis; time the steady state."""
    from epivo_tpu.pipeline import ba, vo

    key = jax.random.PRNGKey(0)
    one = lambda a, b, k: vo.vo_step(a, b, k, cfg)
    spec = ba.mono_window_spec(ba_cfg.window_size)
    ba_fn = lambda T, p, pt, w, m: ba.ba_windows(
        T, spec, p, pt, wreps=w, pmask=m, config=ba_cfg)
    stack = lambda x: np.stack([x] * batch)
    steps = {
        "vo_step_b1": (jax.jit(one), (img0, img1, key)),
        f"vo_step_b{batch}": (jax.jit(jax.vmap(one)), (
            stack(img0), stack(img1), jax.random.split(key, batch))),
        "ba_windows": (jax.jit(ba_fn), tuple(
            ba_data[k] for k in ("T0s", "p", "p_t", "wreps", "pmask"))),
    }
    out = {}
    for name, (fn, args) in steps.items():
        args = jax.device_put(args, device)
        t0 = time.perf_counter()
        lowered = fn.lower(*args)
        compiled = lowered.compile()
        secs = time.perf_counter() - t0
        mem = memory_summary(compiled)
        ms = median_ms(compiled, *args)
        n_lk = lowered.as_text().count("klt_lk_iterate")
        out[name] = {"compile_s": secs, "memory": mem, "ms": ms,
                     "lk_kernel_sites": n_lk}
        log(f"compile {name}: {secs:.2f} s, memory {mem}, "
            f"steady {ms:.3f} ms/call, {n_lk} LK kernel call sites")
        if name.startswith("vo_step") and device.platform == "gpu":
            assert n_lk > 0, "vo_step on the GPU must run the fused LK loop"
        res = compiled(*args)
        leaves = jax.tree_util.tree_leaves(res)
        assert all(np.all(np.isfinite(np.asarray(x)))
                   for x in leaves if jnp.issubdtype(x.dtype, jnp.floating)
                   ), name
    W = int(ba_data["T0s"].shape[0])
    log(f"vo_step: {out['vo_step_b1']['ms']:.3f} ms/frame at B=1, "
        f"{out[f'vo_step_b{batch}']['ms'] / batch:.3f} ms/frame at "
        f"B={batch}; ba_windows: "
        f"{W / out['ba_windows']['ms'] * 1e3:.1f} windows/s at W={W}")
    return out


def check_flow(a, b, valid, what: str) -> dict:
    """Flow agreement at the KLT tolerances; a and b are FlowResults."""
    sa, sb = np.asarray(a.status), np.asarray(b.status)
    valid = np.asarray(valid)
    both = sa & sb & valid
    assert both.sum() > 0, what
    d = np.linalg.norm(np.asarray(a.xy) - np.asarray(b.xy), axis=-1)[both]
    stats = {"median_px": float(np.median(d)), "max_px": float(np.max(d)),
             "close_frac": float(np.mean(d <= FLOW_CLOSE_PX)),
             "status_agree": float(np.mean(sa[valid] == sb[valid])),
             "n": int(both.sum())}
    log(f"{what}: {stats}")
    assert stats["median_px"] <= FLOW_MEDIAN_PX, (what, stats)
    assert stats["close_frac"] >= FLOW_CLOSE_FRAC, (what, stats)
    assert stats["status_agree"] >= STATUS_AGREE_FRAC, (what, stats)
    return stats


def phase_kernels(img0, img1, fe, device, ref_device) -> dict:
    """FAST + NMS and klt.track on ``device`` against ``ref_device`` (the
    same jitted functions), and the fused LK kernel against the XLA scan
    on ``device``: compiled on a GPU, in interpret mode elsewhere."""
    from epivo_tpu.frontend import fast, klt

    score = jax.jit(lambda im: fast.nms3(
        fast.fast_score_map(im, fe.fast_threshold)))
    s_dev = np.asarray(score(jax.device_put(img0, device)))
    s_ref = np.asarray(score(jax.device_put(img0, ref_device)))
    n_diff = int(np.sum(s_dev != s_ref))
    log(f"FAST+NMS {s_dev.shape}: {n_diff} differing pixels, "
        f"{int(np.sum(s_ref > 0))} corners")
    assert s_dev.shape == img0.shape and n_diff == 0

    kp = jax.jit(fast.detect, static_argnums=(1, 2))(
        jax.device_put(img0, ref_device), fe.fast_threshold, fe.max_keypoints)
    kp = jax.tree_util.tree_map(np.asarray, kp)

    def track_fn():
        return jax.jit(lambda a, b, p, v: klt.track(
            a, b, p, valid=v, win=fe.klt_window, levels=fe.klt_levels,
            iters=fe.klt_iters, min_eig=fe.klt_min_eig))

    args = (img0, img1, kp.xy, kp.valid)
    dev_args = jax.device_put(args, device)
    track = track_fn()
    f_dev = track(*dev_args)
    f_ref = track(*jax.device_put(args, ref_device))
    out = {"flow_vs_ref": check_flow(f_dev, f_ref, kp.valid,
                                     "klt.track device vs reference")}
    # klt's own choice on the GPU is the kernel; elsewhere it is the scan.
    if device.platform == "gpu":
        lowered = track.lower(*dev_args).as_text()
        assert "klt_lk_iterate" in lowered, "klt.track must use the LK kernel"
        f_kern = f_dev
        with lk_loop(klt._lk_iterate_scan):
            f_scan = track_fn()(*dev_args)
    else:
        f_scan = f_dev
        with lk_loop(functools.partial(klt._lk_iterate_kernel,
                                       interpret=True)):
            f_kern = track_fn()(*dev_args)
    out["kernel_vs_scan"] = check_flow(
        f_kern, f_scan, kp.valid,
        f"klt.track LK kernel vs XLA scan ({device.platform})")
    return out


def gauge_free(T) -> np.ndarray:
    """[..., 12] rotation entries and unit translation direction of poses
    [..., 4, 4]: what a monocular window determines (its LM energy is
    invariant to the scale of the window's translations)."""
    T = np.asarray(T)
    t = T[..., :3, 3]
    t = t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    return np.concatenate(
        [T[..., :3, :3].reshape(T.shape[:-2] + (9,)), t], axis=-1)


def synthetic_windows(n_windows: int, n_points: int = 32, seed: int = 0):
    """Well-posed ws=3 windows (exact matches of a random scene, perturbed
    initial poses) at the bench's window shapes."""
    from epivo_tpu.datasets import synthetic
    from epivo_tpu.pipeline import ba

    spec = ba.mono_window_spec(3)
    gen = jax.vmap(lambda k: synthetic.gen_scene_sequence(
        k, N=n_points, n_zeta=spec.n_zeta, reps=[tuple(r) for r in spec.reps],
        rot_noise=0.04, t_noise=0.08))
    sc = jax.jit(gen)(jax.random.split(jax.random.PRNGKey(seed), n_windows))
    W, R = n_windows, spec.reps.shape[0]
    return {"T0s": np.asarray(sc.T0s), "p": np.asarray(sc.p),
            "p_t": np.asarray(sc.p_t), "wreps": np.ones((W, R), np.float32),
            "pmask": np.ones((W, R, n_points), bool)}


def ba_window_deltas(a, b):
    """Per-window differences of two ba_windows results (host arrays):
    largest rotation-entry difference, the same over rotation and unit
    translation direction, and relative r_norm difference."""
    W = a.T_opt.shape[0]
    per = lambda x: np.abs(x).reshape(W, -1).max(axis=1)
    rot = per(a.T_opt[..., :3, :3] - b.T_opt[..., :3, :3])
    rot_dir = per(gauge_free(a.T_opt) - gauge_free(b.T_opt))
    rel = np.abs(a.r_norm - b.r_norm) / np.maximum(np.abs(b.r_norm), 1e-30)
    return rot, rot_dir, rel


def compare_ba(a, b, well_posed: bool, what: str) -> dict:
    """Agreement of two ba_windows results (host arrays): the same
    reverted set and every window's rotations within BA_ATOL; on
    well-posed windows also the translation directions, on corridor
    windows the quantiles of the energy difference within
    BA_RNORM_BOUNDS."""
    rot, rot_dir, rel = ba_window_deltas(a, b)
    same_rev = bool(np.array_equal(a.reverted, b.reverted))
    out = {"same_reverted": same_rev, "reverted": int(a.reverted.sum()),
           "rot_max": float(rot.max()), "rot_dir_max": float(rot_dir.max()),
           "rel_r_norm_q": {q: float(np.quantile(rel, q))
                            for q in BA_RNORM_BOUNDS},
           "rel_r_norm_worst": np.argsort(rel)[-3:][::-1].tolist(),
           "T_opt_max_abs": float(np.max(np.abs(a.T_opt - b.T_opt)))}
    log(f"{what}: {out}")
    assert np.all(np.isfinite(a.T_opt)) and same_rev, (what, out)
    assert out["rot_max"] <= BA_ATOL, (what, out)
    if well_posed:
        assert out["rot_dir_max"] <= BA_ATOL, (what, out)
    else:
        for q, bound in BA_RNORM_BOUNDS.items():
            assert out["rel_r_norm_q"][q] <= bound, (what, q, out)
    return out


def phase_ba(ba_data, ba_cfg, device, ref_device, time_it: bool = True):
    """ba_windows with the lane-major LM against the plain vmapped LM on
    ``device``, and against itself on ``ref_device``; windows/s of both.

    Two inputs. On synthetic well-posed windows (W as ``ba_data``, Huber
    1.0 as in the repo's solver parity tests) every pose must agree at
    BA_ATOL in rotation and translation direction. On the committed
    corridor workload, whose windows leave each translation's length free
    (and, where one shrinks towards zero, its direction), every rotation
    must agree at BA_ATOL and the energies within BA_RNORM_BOUNDS.
    Where two solves end at different energies, both have stopped: 100
    LM iterations instead of 30 change neither.
    """
    import dataclasses

    from epivo_tpu.pipeline import ba

    spec = ba.mono_window_spec(ba_cfg.window_size)
    W = int(ba_data["T0s"].shape[0])
    syn_cfg = dataclasses.replace(
        ba_cfg, lm=dataclasses.replace(ba_cfg.lm, huber_delta=1.0))
    inputs = {"synthetic": (synthetic_windows(W), syn_cfg),
              "corridor": (ba_data, ba_cfg)}
    out = {}
    for data_name, (data, cfg) in inputs.items():
        args = tuple(data[k] for k in ("T0s", "p", "p_t", "wreps", "pmask"))

        def solver(use_lanes, cfg=cfg):
            return jax.jit(lambda T, p, pt, w, m: ba.ba_windows(
                T, spec, p, pt, wreps=w, pmask=m, config=cfg,
                use_lanes=use_lanes))

        lanes, plain = solver(True), solver(False)
        dev_args = jax.device_put(args, device)
        get = lambda r: jax.tree_util.tree_map(np.asarray, r)
        r_lanes = get(lanes(*dev_args))
        assert np.all(np.isfinite(r_lanes.T_opt)), data_name
        ref_args = jax.device_put(args, ref_device)
        pairs = (("lanes_vs_plain", get(plain(*dev_args))),
                 ("device_vs_ref", get(lanes(*ref_args))))
        for name, other in pairs:
            key = f"{data_name}_{name}"
            out[key] = compare_ba(r_lanes, other, data_name == "synthetic",
                                  f"ba_windows {key} (W={W})")
        if time_it and data_name == "corridor":
            for name, fn in (("lanes", lanes), ("plain", plain)):
                ms = median_ms(fn, *dev_args)
                out[f"{name}_windows_per_s"] = W / ms * 1e3
                log(f"ba_windows use_lanes={name == 'lanes'}: {ms:.3f} ms "
                    f"per W={W} solve, {W / ms * 1e3:.1f} windows/s")
    return out


def path_length(traj) -> float:
    return float(np.sum(np.linalg.norm(np.diff(traj[:, :3, 3], axis=0),
                                       axis=-1)))


def phase_main(frames, gt, vo_cfg, ba_cfg, batch: int = BENCH_BATCH,
               repeat: bool = True):
    """run_vo_sequence and run_ba_sequence over the frames; accuracy
    asserted, first-run and steady ms/frame printed."""
    from epivo_tpu.pipeline import runners

    L = path_length(gt)
    out = {"path_length": L, "frames": len(frames)}
    runs = {
        "vo": lambda: runners.run_vo_sequence(list(frames), vo_cfg,
                                              gt_poses=gt, batch=batch),
        "ba": lambda: runners.run_ba_sequence(list(frames), ba_cfg,
                                              gt_poses=gt, batch=batch),
    }
    for name, run in runs.items():
        ts = []
        for _ in range(2 if repeat else 1):
            t0 = time.perf_counter()
            res = run()
            ts.append(time.perf_counter() - t0)
        traj = np.asarray(res.trajectory)
        assert traj.shape == (len(frames), 4, 4), traj.shape
        assert np.all(np.isfinite(traj)), name
        ratio = path_length(traj) / L
        per_frame = [t / (len(frames) - 1) * 1e3 for t in ts]
        out[name] = {"ate": float(res.ate), "ate_frac": float(res.ate) / L,
                     "length_ratio": ratio, "ms_per_frame": per_frame}
        log(f"run_{name}_sequence: ATE {res.ate:.4f} m over {L:.2f} m "
            f"({100 * res.ate / L:.3f}%), length ratio {ratio:.4f}, "
            f"ms/frame first {per_frame[0]:.1f}"
            + (f", steady {per_frame[1]:.1f}" if repeat else ""))
    assert out["vo"]["ate_frac"] < VO_ATE_FRAC, out["vo"]
    assert out["ba"]["ate_frac"] < BA_ATE_FRAC, out["ba"]
    return out


# --------------------------------------------------------------------------
# Four-card phases (--four)
# --------------------------------------------------------------------------

def spread_over(x, devices, what: str, split: bool = False) -> None:
    """Assert that ``x`` lives on all of ``devices``; with ``split``, as
    distinct shards (not copies on each)."""
    got = {d.id for d in x.sharding.device_set}
    want = {d.id for d in devices}
    assert got == want, (what, got, want)
    if split:
        assert not x.sharding.is_fully_replicated, (what, x.sharding)


def phase_four_ba(ba_data, ba_cfg, devices) -> dict:
    """Window-sharded BA (dist.distributed_ba_step) against ba_windows on
    one card, on the inputs and bounds of :func:`phase_ba`."""
    import dataclasses

    from epivo_tpu.parallel import dist, mesh as mesh_mod
    from epivo_tpu.pipeline import ba

    spec = ba.mono_window_spec(ba_cfg.window_size)
    W = int(ba_data["T0s"].shape[0])
    mesh = mesh_mod.make_mesh(n_win=len(devices), n_hyp=1, devices=devices)
    syn_cfg = dataclasses.replace(
        ba_cfg, lm=dataclasses.replace(ba_cfg.lm, huber_delta=1.0))
    get = lambda r: jax.tree_util.tree_map(np.asarray, r)
    out = {}
    for name, data, cfg in (("synthetic", synthetic_windows(W), syn_cfg),
                            ("corridor", ba_data, ba_cfg)):
        args = tuple(data[k] for k in ("T0s", "p", "p_t", "wreps", "pmask"))
        one = jax.jit(lambda T, p, pt, w, m, cfg=cfg: ba.ba_windows(
            T, spec, p, pt, wreps=w, pmask=m, config=cfg))
        one_args = jax.device_put(args, devices[0])
        step = dist.distributed_ba_step(mesh, spec, cfg)
        sh_args = jax.device_put(args, mesh_mod.win_sharding(mesh))
        rN = step(*sh_args)
        spread_over(rN.T_opt, devices, "sharded T_opt", split=True)
        assert np.all(np.isfinite(np.asarray(rN.trajectory)))
        out[name] = compare_ba(
            get(rN), get(one(*one_args)), name == "synthetic",
            f"four: window-sharded BA {name} W={W}, 1-vs-{len(devices)}")
        if name == "corridor":
            ms1 = median_ms(one, *one_args)
            msN = median_ms(step, *sh_args)
            out["windows_per_s_1"] = W / ms1 * 1e3
            out[f"windows_per_s_{len(devices)}"] = W / msN * 1e3
            log(f"four: window-sharded BA W={W}: {W / ms1 * 1e3:.1f} "
                f"windows/s on 1 card, {W / msN * 1e3:.1f} on "
                f"{len(devices)}")
    return out


def phase_four_extract(frames, vo_cfg, devices, n_points: int = 32) -> dict:
    """Sharded pair extraction (runners._extract_pairs(mesh=)) against the
    one-card extraction; then the runner's sharded step on one batch must
    leave each card its own slice of the pairs."""
    from epivo_tpu.parallel import mesh as mesh_mod
    from epivo_tpu.pipeline import runners, stream

    n = len(devices)
    pairs = [(i, i + 1) for i in range(len(frames) - 1)]
    mesh = mesh_mod.make_mesh(n_win=n, n_hyp=1, devices=devices)

    def extract(m):
        with jax.default_device(devices[0]):
            t0 = time.perf_counter()
            pd = runners._extract_pairs(stream.FrameStream(list(frames)),
                                        pairs, vo_cfg, 0, n_points=n_points,
                                        batch=BENCH_BATCH, mesh=m)
            return pd, time.perf_counter() - t0

    pd1, t1 = extract(None)
    pdN, tN = extract(mesh)
    assert set(pdN) == set(pd1)
    dTs = np.sort([np.abs(pdN[k]["T"] - pd1[k]["T"]).max() for k in pd1])
    med = float(dTs[len(dTs) // 2])
    out = {"pairs": len(pairs), "median_pose_delta": med,
           "max_pose_delta": float(dTs[-1]), "s_1": t1, "s_N": tN}
    log(f"four: sharded extraction of {len(pairs)} pairs: median pose delta "
        f"{med:.2e} (max {dTs[-1]:.2e}); {t1:.2f} s on 1 card, {tN:.2f} s on "
        f"{n} (first calls, compile included)")
    assert med < PAIR_MEDIAN_DELTA, out

    # The steps _extract_pairs compiled (cached per config and mesh), on
    # one batch of the runner's size, fed as the runner feeds them.
    B = -(-BENCH_BATCH // n) * n
    with jax.default_device(devices[0]):
        _, keys = runners._split_keys(jax.random.PRNGKey(0), B)
        args = (jnp.asarray(np.stack(frames[:B])),
                jnp.asarray(np.stack(frames[1:B + 1])), keys)
    step1 = runners._extract_step(vo_cfg, False, None)
    stepN = runners._extract_step(vo_cfg, False, mesh)
    for i, x in enumerate(stepN(*args)):
        spread_over(x, devices, f"sharded extraction output {i}", split=True)
    with jax.default_device(devices[0]):
        out["ms_per_batch_1"] = median_ms(step1, *args)
    out["ms_per_batch_N"] = median_ms(stepN, *args)
    log(f"four: extraction step, {B} pairs per batch: "
        f"{out['ms_per_batch_1']:.3f} ms on 1 card, "
        f"{out['ms_per_batch_N']:.3f} ms on {n} (steady)")
    return out


def phase_four_ransac(p, p_t, mask, devices, n_hyp_per_device: int = 128,
                      threshold: float = 1e-5) -> dict:
    """Hypothesis-sharded RANSAC against the same hypothesis shards solved
    one after another on one card."""
    from epivo_tpu import ransac as ransac_mod
    from epivo_tpu.geometry import essential
    from epivo_tpu.parallel import dist, mesh as mesh_mod

    n = len(devices)
    mesh = mesh_mod.make_mesh(n_win=1, n_hyp=n, devices=devices)
    key = jax.random.PRNGKey(3)
    fn = dist.distributed_ransac_essential(
        mesh, n_hyp_per_device=n_hyp_per_device, threshold=threshold)
    E_N, inl_N = fn(key, p, p_t, mask)
    spread_over(E_N, devices, "RANSAC E")
    spread_over(inl_N, devices, "RANSAC inliers")

    def reference(key, p, p_t, mask):
        res = [ransac_mod.ransac_essential(
            k, p, p_t, n_hyp=n_hyp_per_device, threshold=threshold,
            mask=mask, refit=False) for k in jax.random.split(key, n)]
        best = int(np.argmax([float(r.best_score) for r in res]))
        E = res[best].E
        return E, (essential.sampson_error(E, p, p_t) < threshold) & mask

    with jax.default_device(devices[0]):
        E_1, inl_1 = reference(
            *jax.device_put((key, p, p_t, mask), devices[0]))
    # E is defined up to sign.
    E_N, E_1 = np.asarray(E_N), np.asarray(E_1)
    dE = float(min(np.abs(E_N - E_1).max(), np.abs(E_N + E_1).max()))
    agree = float(np.mean(np.asarray(inl_N) == np.asarray(inl_1)))
    out = {"E_max_abs": dE, "inlier_agree": agree,
           "inliers": int(np.asarray(inl_N).sum())}
    log(f"four: hypothesis-sharded RANSAC ({n} x {n_hyp_per_device}): "
        f"max|dE| {dE:.2e}, inlier agreement {agree:.4f}, "
        f"{out['inliers']} inliers")
    assert dE <= BA_ATOL and agree >= STATUS_AGREE_FRAC, out
    return out


def phase_four_global(devices, n_zeta: int = 64, n_points: int = 32) -> dict:
    """Constraint-sharded global BA against the unsharded solve: poses
    within BA_ATOL in rotation and translation direction (the chain's
    monocular constraints leave each translation's scale free)."""
    from epivo_tpu.datasets import synthetic
    from epivo_tpu.parallel import global_ba, mesh as mesh_mod

    n = len(devices)
    reps = ([(i, i) for i in range(n_zeta)]
            + [(i, i + 1) for i in range(n_zeta - 1)])
    with jax.default_device(devices[0]):
        sc = synthetic.gen_scene_sequence(jax.random.PRNGKey(7), N=n_points,
                                          n_zeta=n_zeta, reps=reps)
    R0 = sc.reps.shape[0]
    pad = -R0 % n
    reps_p = np.concatenate([sc.reps, np.zeros((pad, 2), np.int32)])
    padded = lambda x: jnp.concatenate(
        [x, jnp.ones((pad,) + x.shape[1:], x.dtype)])
    args = (sc.T0s, reps_p, padded(sc.p), padded(sc.p_t))
    w = jnp.concatenate([jnp.ones(R0), jnp.zeros(pad)])
    kw = dict(wreps=w, max_span=2, max_iters=10, cg_iters=16,
              huber_delta=1.0)
    with jax.default_device(devices[0]):
        r1 = global_ba.global_ba_solve(*args, **kw)
    mesh = mesh_mod.make_mesh(n_win=n, n_hyp=1, devices=devices)
    rN = global_ba.global_ba_solve(*args, mesh=mesh, **kw)
    spread_over(rN.T0s, devices, "global BA T0s")
    d = float(np.max(np.abs(gauge_free(rN.T0s) - gauge_free(r1.T0s))))
    out = {"rot_dir_max_abs": d, "constraints": R0,
           "T0s_max_abs": float(np.max(np.abs(np.asarray(rN.T0s)
                                              - np.asarray(r1.T0s)))),
           "r_norm_1": float(r1.r_norm), "r_norm_N": float(rN.r_norm)}
    log(f"four: constraint-sharded global BA ({R0} constraints, {n_zeta} "
        f"poses), 1-vs-{n}: {out}")
    assert np.all(np.isfinite(np.asarray(rN.T0s)))
    assert d <= BA_ATOL, out
    return out


def device_peaks(devices) -> list:
    """Peak bytes in use on each device (None where not reported)."""
    stats = [d.memory_stats() or {} for d in devices]
    return [s.get("peak_bytes_in_use") for s in stats]


def pair_matches(img0, img1, vo_cfg, device):
    """Normalised matches (p, p_t, tracked) of one frame pair, detected
    and tracked on ``device``, and the squared RANSAC threshold of the
    ``--mode ba`` configuration for its camera."""
    from epivo_tpu.frontend import fast, klt
    from epivo_tpu.geometry import camera as cam
    from epivo_tpu.pipeline.config import kitti_config

    fe, camera = vo_cfg.frontend, vo_cfg.camera
    with jax.default_device(device):
        a, b = jnp.asarray(img0), jnp.asarray(img1)
        kp = fast.detect(a, fe.fast_threshold, fe.max_keypoints)
        fl = klt.track(a, b, kp.xy, valid=kp.valid, levels=fe.klt_levels,
                       iters=fe.klt_iters)
        K_inv = camera.K_inv(jnp.float32)
        p, p_t = cam.normalize(kp.xy, K_inv), cam.normalize(fl.xy, K_inv)
    thr = (kitti_config("ba", camera).ransac.threshold_px / camera.fx) ** 2
    return p, p_t, fl.status & kp.valid, thr


def run_four(devices) -> None:
    vo_cfg = bench_vo_config()
    ba_cfg = bench_ba_config()
    phase_four_ba(load_ba_workload(), ba_cfg, devices)
    frames, _ = render_corridor(33)
    phase_four_extract(frames, vo_cfg, devices)
    # RANSAC on the matches of one KITTI-size pair, tracked on one card.
    p, p_t, mask, thr = pair_matches(frames[0], frames[1], vo_cfg, devices[0])
    phase_four_ransac(p, p_t, mask, devices, threshold=thr)
    phase_four_global(devices)
    peaks = device_peaks(devices)
    log(f"four: peak bytes in use per device {peaks}")
    assert all(pk is None or pk > 0 for pk in peaks), peaks


# --------------------------------------------------------------------------

def run_one(device) -> None:
    from epivo_tpu.geometry import camera as cam
    from epivo_tpu.pipeline.config import kitti_config

    cpu = jax.devices("cpu")[0]
    vo_cfg = bench_vo_config()
    ba_cfg = bench_ba_config()
    frames, gt = render_corridor(65)
    ba_data = load_ba_workload()
    phase_compile(vo_cfg, frames[0], frames[1], ba_data, ba_cfg, device)
    phase_kernels(frames[0], frames[1], vo_cfg.frontend, device, cpu)
    phase_ba(ba_data, ba_cfg, device, cpu)
    with jax.default_device(device):
        phase_main(frames, gt, kitti_config("vo", cam.KITTI_00),
                   kitti_config("ba", cam.KITTI_00))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args(argv)
    n = 4 if args.four else 1
    # The CPU backend is the in-process reference: keep it available when
    # the environment restricts JAX to the GPU.
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")
    devices = require_gpu(n)
    import epivo_tpu
    from epivo_tpu.utils import compile_cache

    pkg = os.path.dirname(os.path.abspath(epivo_tpu.__file__))
    assert pkg == os.path.join(HERE, "epivo_tpu"), pkg
    assert os.path.exists(BA_WORKLOAD), BA_WORKLOAD
    log(f"device: {devices[0].platform} {devices[0].device_kind} x "
        f"{len(jax.devices())}; cache {compile_cache.enable()}")
    log(f"card: {card_info()}")
    t0 = time.perf_counter()
    if args.four:
        run_four(devices)
    else:
        run_one(devices[0])
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
