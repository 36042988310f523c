"""Tests for oriented BRIEF descriptors and matmul Hamming matching."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from epivo_tpu.frontend import fast, match, orb


def textured_image(H=128, W=160, seed=0, n_blobs=40):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = np.zeros((H, W), np.float32)
    cs = rng.uniform(12, min(H, W) - 12, size=(n_blobs, 2))
    amp = rng.uniform(80, 255, n_blobs)
    sig = rng.uniform(1.2, 3.0, n_blobs)
    for (cy, cx), a, s in zip(cs, amp, sig):
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s**2))
    return jnp.asarray(np.clip(img, 0, 255))


def test_pattern_deterministic():
    p1 = orb.brief_pattern()
    p2 = orb.brief_pattern()
    np.testing.assert_array_equal(p1, p2)
    assert p1.shape == (256, 4)
    assert np.abs(p1).max() <= orb.PATCH // 2


def test_descriptor_shapes_and_packing():
    img = textured_image()
    kp = fast.detect(img, 15.0, 64)
    d = orb.describe(img, kp.xy, kp.valid)
    assert d.signs.shape == (64, 256)
    assert d.packed.shape == (64, 8)
    assert set(np.unique(np.asarray(d.signs))) <= {-1.0, 1.0}
    # packing round-trip
    bits = ((np.asarray(d.packed)[:, :, None] >> np.arange(32)[None, None, :]) & 1)
    np.testing.assert_array_equal(
        bits.reshape(64, 256), (np.asarray(d.signs) > 0).astype(int)
    )


def test_descriptor_invariant_to_same_image():
    img = textured_image()
    kp = fast.detect(img, 15.0, 32)
    d1 = orb.describe(img, kp.xy)
    d2 = orb.describe(img, kp.xy)
    np.testing.assert_array_equal(np.asarray(d1.signs), np.asarray(d2.signs))


def test_descriptor_matches_under_translation():
    img = textured_image()
    shift = 5
    img2 = jnp.roll(img, (0, shift), axis=(0, 1))
    kp = fast.detect(img, 20.0, 48)
    sel = np.asarray(kp.valid) & (np.asarray(kp.xy[:, 0]) < 160 - 16)
    d1 = orb.describe(img, kp.xy, jnp.asarray(sel))
    xy2 = kp.xy + jnp.array([shift, 0.0])
    d2 = orb.describe(img2, xy2, jnp.asarray(sel))
    # Same content => near-identical descriptors.
    ham = (256 - jnp.einsum("kb,kb->k", d1.signs, d2.signs)) / 2
    ham = np.asarray(ham)[sel]
    assert np.median(ham) < 20, np.median(ham)


def test_descriptor_rotation_steering():
    """A rotated image should still match via steered descriptors."""
    from scipy.ndimage import rotate

    img_np = np.asarray(textured_image())
    ang = 30.0
    img_rot = rotate(img_np, -ang, reshape=False, order=3)
    img = jnp.asarray(img_np)
    img2 = jnp.asarray(img_rot.astype(np.float32))
    # track one strong keypoint at image center region under rotation
    kp = fast.detect(img, 25.0, 16)
    c = np.array([img_np.shape[1] / 2 - 0.5, img_np.shape[0] / 2 - 0.5])
    th = np.deg2rad(ang)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    xy1 = np.asarray(kp.xy)
    xy2 = (R @ (xy1 - c).T).T + c
    inb = (
        (xy2[:, 0] > 20) & (xy2[:, 0] < 140) & (xy2[:, 1] > 20) & (xy2[:, 1] < 108)
        & np.asarray(kp.valid)
    )
    d1 = orb.describe(img, kp.xy)
    d2 = orb.describe(img2, jnp.asarray(xy2.astype(np.float32)))
    ham = np.asarray((256 - jnp.einsum("kb,kb->k", d1.signs, d2.signs)) / 2)
    assert np.median(ham[inb]) < 60, np.median(ham[inb])


def test_hamming_table_exact():
    rng = np.random.default_rng(0)
    a = jnp.asarray(np.sign(rng.normal(size=(5, 256))).astype(np.float32))
    b = jnp.asarray(np.sign(rng.normal(size=(7, 256))).astype(np.float32))
    D = np.asarray(match.hamming_table(a, b))
    for i in range(5):
        for j in range(7):
            expect = np.sum(np.asarray(a)[i] != np.asarray(b)[j])
            assert D[i, j] == expect


def test_match_cross_check_and_mask():
    rng = np.random.default_rng(1)
    base = np.sign(rng.normal(size=(20, 256))).astype(np.float32)
    # set 2 = permuted set 1 with small corruption
    perm = rng.permutation(20)
    noisy = base[perm].copy()
    flips = rng.integers(0, 256, size=(20, 10))
    for i in range(20):
        noisy[i, flips[i]] *= -1
    res = match.match(jnp.asarray(base), jnp.asarray(noisy), max_dist=40.0)
    idx = np.asarray(res.idx)
    ok = np.asarray(res.valid)
    assert ok.mean() > 0.9
    inv = np.argsort(perm)
    np.testing.assert_array_equal(idx[ok], inv[np.arange(20)][ok])
    # invalid lanes excluded
    v2 = jnp.asarray(np.arange(20) != inv[0])
    res2 = match.match(jnp.asarray(base), jnp.asarray(noisy), valid2=v2)
    assert not bool(res2.valid[0])


def test_end_to_end_orb_matching_pipeline():
    """FAST -> ORB -> Hamming match across a shifted image; matches should
    land at the shifted positions (the reference's really_robust_ass path)."""
    img = textured_image(seed=3)
    shift = 7
    img2 = jnp.roll(img, (0, shift), axis=(0, 1))
    kp1 = fast.detect(img, 20.0, 64)
    kp2 = fast.detect(img2, 20.0, 64)
    d1 = orb.describe(img, kp1.xy, kp1.valid)
    d2 = orb.describe(img2, kp2.xy, kp2.valid)
    res = match.match(d1.signs, d2.signs, valid1=kp1.valid, valid2=kp2.valid,
                      max_dist=60.0)
    n_checked = 0
    for i in np.flatnonzero(np.asarray(res.valid)):
        p1 = np.asarray(kp1.xy[i])
        p2 = np.asarray(kp2.xy[int(res.idx[i])])
        if p1[0] + shift < 155:
            np.testing.assert_allclose(p2, p1 + [shift, 0], atol=1.5)
            n_checked += 1
    assert n_checked >= 10


def test_vo_step_orb_pipeline():
    """ORB-matched two-view VO recovers the pose on a rendered scene."""
    import jax.numpy as jnp
    from epivo_tpu.geometry import se3
    from epivo_tpu.pipeline import vo
    from tests.test_pipeline import SMALL_CFG, render

    H, W = 120, 160
    cfg = SMALL_CFG
    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    z = jax.random.uniform(k1, (90,), minval=6.0, maxval=15.0)
    xy = jax.random.uniform(k2, (90, 2), minval=-0.4, maxval=0.4) * z[:, None]
    X = jnp.concatenate([xy, z[:, None]], axis=-1)
    T_gt = se3.se3_exp(jnp.array([0.05, -0.03, 0.4, 0.01, -0.015, 0.008]))
    img0 = render(X, cfg.camera.K(), se3.identity(), H, W)
    img1 = render(X, cfg.camera.K(), T_gt, H, W)

    res = vo.vo_step_orb(img0, img1, k3, cfg)
    assert int(res.n_tracked) > 20
    assert int(res.n_inliers) > 15
    R_gt, t_gt = se3.matrix_to_rt(T_gt)
    rot_err = float(jnp.linalg.norm(res.T[:3, :3] - R_gt))
    assert rot_err < 0.05, rot_err


def test_vo_step_orb_too_few_matches():
    """Textureless frames -> identity fallback, not a crash."""
    import jax.numpy as jnp
    from epivo_tpu.pipeline import vo
    from tests.test_pipeline import SMALL_CFG

    img = jnp.full((120, 160), 50.0)
    res = vo.vo_step_orb(img, img, jax.random.PRNGKey(0), SMALL_CFG)
    assert int(res.n_tracked) < 8
    np.testing.assert_allclose(np.asarray(res.T[:3, :3]), np.eye(3), atol=1e-6)


def test_pyramid_orb_survives_zoom_and_roll():
    """Track across a 1.5x zoom + 30 deg roll: the pyramid descriptors must
    find geometrically-correct matches where single-scale ORB collapses
    (the reference's multi-scale regime, `kitti_ba.cpp:128`)."""
    from scipy.ndimage import affine_transform

    H, W = 200, 260
    img_np = np.asarray(textured_image(H=H, W=W, n_blobs=90, seed=5))
    s, th = 1.5, np.deg2rad(30.0)
    c_yx = np.array([(H - 1) / 2.0, (W - 1) / 2.0])
    # Rotation by th in xy convention, expressed on (y, x) vectors.
    M_yx = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
    A = np.linalg.inv(s * M_yx)  # output -> input mapping
    img2_np = affine_transform(img_np, A, offset=c_yx - A @ c_yx, order=3)
    img, img2 = jnp.asarray(img_np), jnp.asarray(img2_np.astype(np.float32))

    def forward_xy(xy):
        # xy [N, 2] in (x, y); w2 = s M_yx (w1 - c) + c on (y, x).
        w1 = xy[:, ::-1] - c_yx
        w2 = (s * M_yx @ w1.T).T + c_yx
        return w2[:, ::-1]

    def correct_matches(kp0, d0, kp1, d1):
        res = match.match(d0.signs, d1.signs, valid1=kp0.valid,
                          valid2=kp1.valid, max_dist=70.0)
        idx = np.asarray(res.idx)
        ok = np.asarray(res.valid)
        src = np.asarray(kp0.xy)
        tgt = np.asarray(kp1.xy)
        pred = forward_xy(src)
        inb = (pred[:, 0] > 5) & (pred[:, 0] < W - 5) & (pred[:, 1] > 5) \
            & (pred[:, 1] < H - 5)
        good = 0
        for i in np.flatnonzero(ok & inb):
            if np.linalg.norm(tgt[idx[i]] - pred[i]) < 4.0:
                good += 1
        return good

    kp0 = fast.detect(img, 15.0, 256)
    kp1 = fast.detect(img2, 15.0, 256)
    single = correct_matches(kp0, orb.describe(img, kp0.xy, kp0.valid),
                             kp1, orb.describe(img2, kp1.xy, kp1.valid))

    p0 = orb.detect_and_describe_pyramid(img, 15.0, 256, n_levels=8)
    p1 = orb.detect_and_describe_pyramid(img2, 15.0, 256, n_levels=8)
    pyr = correct_matches(p0[0], p0[1], p1[0], p1[1])

    assert pyr >= 12, (pyr, single)
    assert pyr >= 2 * max(single, 1), (pyr, single)


def test_pyramid_orb_detection():
    img = textured_image(H=200, W=260, n_blobs=80)
    kps, descs, levels = orb.detect_and_describe_pyramid(
        img, threshold=15.0, max_keypoints=256, n_levels=4
    )
    assert kps.xy.shape[0] == descs.signs.shape[0] == levels.shape[0]
    n_valid = int(kps.valid.sum())
    assert n_valid > 30
    # Detections from coarser levels exist and map inside the image.
    lv = np.asarray(levels)[np.asarray(kps.valid)]
    assert lv.max() >= 1
    pts = np.asarray(kps.xy)[np.asarray(kps.valid)]
    assert pts[:, 0].max() < 260 and pts[:, 1].max() < 200
