"""``chip_smoke.py`` on the CPU: its phases at tiny sizes (device and
reference both on the CPU), and its refusal to run without a GPU."""

import dataclasses
import json

import jax
import numpy as np
import pytest

import chip_smoke as cs
from epivo_tpu.frontend import klt
from epivo_tpu.pipeline import ba
from epivo_tpu.geometry.camera import Pinhole
from epivo_tpu.pipeline.config import (
    FrontendConfig, RansacConfig, kitti_config,
)

H, W = 120, 160
CAM = Pinhole(fx=130.0, fy=130.0, cx=W / 2, cy=H / 2, width=W, height=H)
FE = FrontendConfig(fast_threshold=20.0, max_keypoints=128, klt_levels=3)


@pytest.fixture(scope="module")
def frames():
    return cs.render_corridor(9, hw=(H, W), camera=CAM, seed=1)


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_without_gpu(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cs.main(argv)
    assert e.value.code not in (0, None)
    out = capsys.readouterr().out
    assert '"ok": true' not in out and "needs" in out


def test_phase_kernels_against_cpu_reference(frames):
    """On the CPU the phase holds the LK kernel (interpret mode) against
    klt's own loop there, the XLA scan."""
    imgs, _ = frames
    cpu = jax.devices("cpu")[0]
    out = cs.phase_kernels(imgs[0], imgs[1], FE, cpu, cpu)
    ks = out["kernel_vs_scan"]
    assert ks["n"] > 50 and ks["median_px"] <= cs.FLOW_MEDIAN_PX
    assert ks["status_agree"] >= cs.STATUS_AGREE_FRAC


def test_check_flow_rejects_drift():
    K = 200
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 100, (K, 2)).astype(np.float32)
    ok = np.ones(K, bool)
    a = klt.FlowResult(xy=xy, status=ok, err=np.zeros(K))
    cs.check_flow(a, a, ok, "identical")
    b = klt.FlowResult(xy=xy + 0.01, status=ok, err=np.zeros(K))
    with pytest.raises(AssertionError):
        cs.check_flow(a, b, ok, "shifted")


def test_phase_ba_lanes_plain_and_reference():
    cpu = jax.devices("cpu")[0]
    out = cs.phase_ba(cs.load_ba_workload(8), cs.bench_ba_config(), cpu, cpu,
                      time_it=False)
    assert out["synthetic_lanes_vs_plain"]["rot_dir_max"] <= cs.BA_ATOL
    assert out["corridor_device_vs_ref"]["same_reverted"]


def test_compare_ba_bounds_corridor_windows():
    """A few corridor windows may end at another energy; a tenth of them
    may not, and no window's rotation may differ."""
    W = 64
    rng = np.random.default_rng(0)
    T = np.tile(np.eye(4, dtype=np.float32), (W, 2, 1, 1))
    T[..., :3, 3] = rng.normal(size=(W, 2, 3))
    res = lambda T, r: ba.BAWindowsResult(
        T_opt=T, r_norm=r, reverted=np.zeros(W, bool),
        n_accepted=np.zeros(W, np.int32))
    r = rng.uniform(1e-6, 4e-6, W).astype(np.float32)
    a = res(T, r)
    scaled = T.copy()
    scaled[..., :3, 3] *= 1.7  # the free translation length
    r_one = r.copy()
    r_one[3] *= 1.1
    out = cs.compare_ba(res(scaled, r_one), a, False, "one energy apart")
    assert out["rel_r_norm_worst"][0] == 3
    r_many = r * np.where(np.arange(W) < 8, 1.01, 1.0).astype(np.float32)
    with pytest.raises(AssertionError):
        cs.compare_ba(res(T, r_many), a, False, "eight energies apart")
    turned = T.copy()
    turned[3, 0, :3, :3] = _rot_z(0.02)
    with pytest.raises(AssertionError):
        cs.compare_ba(res(turned, r), a, False, "one rotation apart")
    bent = T.copy()
    bent[3, 0, :3, 3] += [0.0, 0.5, 0.0]
    cs.compare_ba(res(bent, r), a, False, "direction, corridor")
    with pytest.raises(AssertionError):
        cs.compare_ba(res(bent, r), a, True, "direction, well-posed")


def _rot_z(t):
    c, s = np.cos(t), np.sin(t)
    return np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def test_gauge_free_ignores_translation_scale():
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    T[:, :3, 3] = [[1.0, 2.0, 2.0], [0.0, 0.0, 3.0], [4.0, 0.0, 3.0]]
    S = T.copy()
    S[:, :3, 3] *= 7.5
    np.testing.assert_allclose(cs.gauge_free(T), cs.gauge_free(S), atol=1e-6)
    assert cs.gauge_free(T).shape == (3, 12)


def test_phase_main_tiny(frames):
    imgs, gt = frames
    vo_cfg = dataclasses.replace(
        kitti_config("vo", CAM), frontend=FE,
        ransac=RansacConfig(n_hyp=128, method="lmeds"))
    ba_cfg = dataclasses.replace(kitti_config("ba", CAM), frontend=FE,
                                 ransac=RansacConfig(n_hyp=128))
    out = cs.phase_main(imgs, gt, vo_cfg, ba_cfg, batch=4, repeat=False)
    assert out["frames"] == 9
    json.dumps(out)  # the summary stays serialisable


@pytest.fixture(scope="module")
def four():
    return jax.devices("cpu")[:4]


def test_phase_four_ba_on_virtual_devices(four):
    out = cs.phase_four_ba(cs.load_ba_workload(8), cs.bench_ba_config(),
                           four)
    assert out["synthetic"]["rot_dir_max"] <= cs.BA_ATOL
    assert out["corridor"]["same_reverted"]


def test_phase_four_ransac_and_global_on_virtual_devices(frames, four):
    imgs, _ = frames
    vo_cfg = dataclasses.replace(kitti_config("vo", CAM), frontend=FE)
    p, p_t, mask, thr = cs.pair_matches(imgs[0], imgs[1], vo_cfg, four[0])
    out = cs.phase_four_ransac(p, p_t, mask, four, n_hyp_per_device=32,
                               threshold=thr)
    assert out["inliers"] > 0
    out = cs.phase_four_global(four, n_zeta=8, n_points=16)
    assert out["rot_dir_max_abs"] <= cs.BA_ATOL


def test_spread_over_rejects_one_device_and_copies(four):
    from epivo_tpu.parallel import mesh as mesh_mod

    mesh = mesh_mod.make_mesh(n_win=4, n_hyp=1, devices=four)
    x = jax.device_put(np.zeros((8, 3)), mesh_mod.win_sharding(mesh))
    cs.spread_over(x, four, "sharded", split=True)
    copies = jax.device_put(np.zeros((8, 3)), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec()))
    cs.spread_over(copies, four, "replicated")
    with pytest.raises(AssertionError):
        cs.spread_over(copies, four, "replicated", split=True)
    with pytest.raises(AssertionError):
        cs.spread_over(jax.device_put(np.zeros(3), four[0]), four, "one")


def test_phase_four_extract_on_virtual_devices(frames, four):
    imgs, _ = frames
    vo_cfg = dataclasses.replace(
        kitti_config("vo", CAM), frontend=FE,
        ransac=RansacConfig(n_hyp=128, method="lmeds"))
    out = cs.phase_four_extract(imgs, vo_cfg, four, n_points=16)
    assert out["pairs"] == 8 and out["ms_per_batch_N"] > 0
