"""KLT window extraction and the fused LK loop kernel, on the CPU.

``klt._extract_windows`` is checked against numpy slicing at the
tracker's real shapes. The Pallas (Triton) LK kernel runs in interpret
mode against ``klt._lk_iterate_scan``; the platform choice between the
two is checked by lowering for CUDA and for the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from epivo_tpu.frontend import klt


def _ref_windows(img, o, S):
    img = np.asarray(img)
    return np.stack([img[y:y + S, x:x + S] for x, y in np.asarray(o)])


@pytest.mark.parametrize("H,W,S,K", [
    (376, 1241, 34, 512),   # KITTI full-res tracking window
    (376, 1241, 46, 512),   # top-level margin-12 window
    (47, 155, 34, 512),     # coarsest pyramid level (origins clamp hard)
    (64, 96, 24, 37),       # tiny image, odd keypoint count
])
def test_extract_windows_matches_slicing(H, W, S, K):
    rng = np.random.default_rng(42)
    img = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    centers = jnp.asarray(rng.uniform(-5, [W + 5, H + 5], (K, 2))
                          .astype(np.float32))
    wins, o = klt._extract_windows(img, centers, S)
    o_int = np.asarray(o).astype(np.int64)
    assert wins.shape == (K, S, S)
    assert (o_int >= 0).all() and (o_int[:, 0] <= W - S).all()
    assert (o_int[:, 1] <= H - S).all()
    np.testing.assert_array_equal(np.asarray(wins),
                                  _ref_windows(img, o_int, S))


def test_extract_windows_edges_and_corners():
    H, W, S = 80, 200, 34
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    r = S // 2
    # The four corners, the clamp boundaries and points outside the image.
    centers = jnp.asarray([[r, r], [W - 1, 0], [0, H - 1], [W - 1, H - 1],
                           [-40, 40], [W + 40, 40], [100, -40], [100, H + 9],
                           [r + 0.4, r + 0.6]], jnp.float32)
    wins, o = klt._extract_windows(img, centers, S)
    o_int = np.asarray(o).astype(np.int64)
    np.testing.assert_array_equal(
        o_int[:4], [[0, 0], [W - S, 0], [0, H - S], [W - S, H - S]])
    np.testing.assert_array_equal(np.asarray(wins),
                                  _ref_windows(img, o_int, S))


def test_extract_windows_vmap():
    B, H, W, S, K = 3, 60, 150, 24, 16
    rng = np.random.default_rng(1)
    imgs = jnp.asarray(rng.uniform(0, 255, (B, H, W)).astype(np.float32))
    centers = jnp.asarray(rng.uniform(0, [W, H], (B, K, 2)).astype(np.float32))
    wins, o = jax.vmap(lambda im, c: klt._extract_windows(im, c, S))(
        imgs, centers)
    for b in range(B):
        np.testing.assert_array_equal(
            np.asarray(wins[b]),
            _ref_windows(imgs[b], np.asarray(o[b]).astype(np.int64), S))


def _lk_operands(K, S=34, win=21, H=80, W=120, seed=1):
    rng = np.random.default_rng(seed)
    img = np.cumsum(np.cumsum(rng.normal(size=(H, W)), 0), 1)
    o = np.stack([rng.integers(0, W - S + 1, K),
                  rng.integers(0, H - S + 1, K)], -1)
    T, Ix, Iy = (rng.normal(size=(win, win, K)) for _ in range(3))
    q0 = rng.uniform(0, S - win - 1.1, size=(K, 2))
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return (f32(img), jnp.asarray(o, jnp.int32), f32(T), f32(Ix), f32(Iy),
            f32(q0))


def _kernel(args, S, iters, eps):
    return klt._lk_iterate_kernel(*args, S, iters, eps, interpret=True)


@pytest.mark.parametrize("S", [34, 46])
def test_lk_kernel_interpret_matches_scan(S):
    """K=130 (not a power of two) at both search-window sizes the tracker
    uses; 7 iterations leave some keypoints unconverged, so the early exit
    and the freeze both run."""
    iters, eps = 7, 0.01
    args = _lk_operands(130, S)
    q_s, e_s = klt._lk_iterate_scan(*args, S, iters, eps)
    q_k, e_k = _kernel(args, S, iters, eps)
    assert q_k.shape == (130, 2) and e_k.shape == (130,)
    np.testing.assert_allclose(np.asarray(q_k), np.asarray(q_s), atol=1e-4)
    np.testing.assert_allclose(np.asarray(e_k), np.asarray(e_s), rtol=1e-4,
                               atol=1e-4)


def test_lk_kernel_interpret_under_vmap():
    S, iters, eps = 34, 5, 0.01
    a, b = _lk_operands(33, S, seed=2), _lk_operands(33, S, seed=3)
    batched = tuple(jnp.stack([x, y]) for x, y in zip(a, b))
    q_b, e_b = jax.vmap(lambda *xs: _kernel(xs, S, iters, eps))(*batched)
    for i, args in enumerate((a, b)):
        q_s, e_s = klt._lk_iterate_scan(*args, S, iters, eps)
        np.testing.assert_allclose(np.asarray(q_b[i]), np.asarray(q_s),
                                   atol=1e-4)
        np.testing.assert_allclose(np.asarray(e_b[i]), np.asarray(e_s),
                                   rtol=1e-4, atol=1e-4)


def test_lk_loop_choice_by_platform():
    """CUDA lowering carries the Triton kernel and no scan; the CPU runs
    the scan."""
    S, iters, eps = 34, 3, 0.01
    args = _lk_operands(16, S)
    fn = jax.jit(lambda *a: klt._lk_iterate(*a, S, iters, eps))
    cuda = fn.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "klt_lk_iterate" in cuda and "stablehlo.while" not in cuda
    cpu = fn.trace(*args).lower(lowering_platforms=("cpu",)).as_text()
    assert "klt_lk_iterate" not in cpu and "stablehlo.while" in cpu
    q, e = fn(*args)
    q_s, e_s = klt._lk_iterate_scan(*args, S, iters, eps)
    np.testing.assert_allclose(np.asarray(q), np.asarray(q_s), atol=1e-5)
