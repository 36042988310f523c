"""The pyramidal-LK iteration loop as one fused Pallas (Triton) kernel.

``klt._lk_iterate_scan`` runs the loop as a ``lax.scan``: each of the 30
iterations of each pyramid level is several small XLA kernels over the
whole keypoint set, and no fusion crosses an iteration. This kernel runs
every iteration of one level in a single launch:

- each program owns one keypoint;
- the template and its gradients live in registers for the whole loop,
  keypoint-major and padded from win x win to 32 x 32 with masks;
- every iteration samples the target patch with four masked gathers
  straight from the target image (no window extraction);
- a program stops as soon as its keypoint has converged.

The iterates equal the scan's up to float32 summation order. ``klt``
calls it on CUDA backends only; ``interpret=True`` runs it on the CPU for
tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

PATCH = 32  # power-of-two cover of the patch edge (win <= 32)
# One keypoint and four warps per program: at K=512, win=21, 30 iterations
# this was the fastest of {1, 2, 4} keypoints x {4, 8} warps per program
# on an H100 (0.177 ms at S=34, 0.212 ms at S=46; at 12 iterations no
# shape won every run). Larger blocks only add padding and gather traffic.
NUM_WARPS = 4


def _lk_kernel(img_ref, ox_ref, oy_ref, qx_ref, qy_ref, T_ref, Ix_ref,
               Iy_ref, qx_out, qy_out, err_out, *, W, win, S, iters, eps):
    """One keypoint (a leading axis of length 1). Image and template refs
    are flat; every load is a gather at computed offsets, masked to the
    win x win patch inside the 32 x 32 block."""
    k = pl.program_id(0) + jnp.zeros((1,), jnp.int32)
    r = jnp.arange(PATCH, dtype=jnp.int32)[None, :, None]
    c = jnp.arange(PATCH, dtype=jnp.int32)[None, None, :]
    pmask = (r < win) & (c < win)
    toff = k[:, None, None] * (win * win) + r * win + c
    T = plgpu.load(T_ref.at[toff], mask=pmask, other=0.0)
    Ix = plgpu.load(Ix_ref.at[toff], mask=pmask, other=0.0)
    Iy = plgpu.load(Iy_ref.at[toff], mask=pmask, other=0.0)

    def patch_sum(x):  # [1, PATCH, PATCH] -> [1]
        return jnp.sum(jnp.sum(x, axis=2), axis=1)

    Gxx = patch_sum(Ix * Ix)
    Gxy = patch_sum(Ix * Iy)
    Gyy = patch_sum(Iy * Iy)
    det = Gxx * Gyy - Gxy * Gxy
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)

    ox = plgpu.load(ox_ref.at[k])
    oy = plgpu.load(oy_ref.at[k])
    hi = jnp.float32(S - win - 1 - 1e-3)
    qx0 = jnp.clip(plgpu.load(qx_ref.at[k]), 0.0, hi)
    qy0 = jnp.clip(plgpu.load(qy_ref.at[k]), 0.0, hi)

    def sample(qx, qy):
        """Bilinear patch at top-left (ox + qx, oy + qy), as klt's sampler."""
        fqx, fqy = jnp.floor(qx), jnp.floor(qy)
        fx = (qx - fqx)[:, None, None]
        fy = (qy - fqy)[:, None, None]
        row = (oy + fqy.astype(jnp.int32))[:, None, None] + r
        col = (ox + fqx.astype(jnp.int32))[:, None, None] + c
        off = row * W + col
        at = lambda o: plgpu.load(img_ref.at[o], mask=pmask, other=0.0)
        return (at(off) * (1 - fx) * (1 - fy) + at(off + 1) * fx * (1 - fy)
                + at(off + W) * (1 - fx) * fy + at(off + W + 1) * fx * fy)

    def cond(carry):
        it, _, _, active = carry
        return (it < iters) & (jnp.max(active) > 0)

    def body(carry):
        it, qx, qy, active = carry
        dI = sample(qx, qy) - T
        bx = patch_sum(dI * Ix)
        by = patch_sum(dI * Iy)
        dx = -(Gyy * bx - Gxy * by) * inv_det
        dy = -(-Gxy * bx + Gxx * by) * inv_det
        live = active > 0
        qx = jnp.where(live, jnp.clip(qx + dx, 0.0, hi), qx)
        qy = jnp.where(live, jnp.clip(qy + dy, 0.0, hi), qy)
        active = jnp.where(jnp.sqrt(dx * dx + dy * dy) < eps, 0, active)
        return it + 1, qx, qy, active

    # ``active`` is int32: the loop carry stays clear of i1 tensors.
    _, qx, qy, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), qx0, qy0, jnp.ones((1,), jnp.int32)))
    err = patch_sum(jnp.where(pmask, jnp.abs(sample(qx, qy) - T), 0.0))
    plgpu.store(qx_out.at[k], qx)
    plgpu.store(qy_out.at[k], qy)
    plgpu.store(err_out.at[k], err / (win * win))


@functools.partial(jax.jit, static_argnames=("S", "iters", "eps",
                                             "interpret"))
def lk_iterate(img, o, T, Ix, Iy, q0, S: int, iters: int, eps: float, *,
               interpret: bool = False):
    """All LK iterations of one pyramid level, one program per keypoint.

    img: [H, W] target level; o: [K, 2] int32 (x, y) origins of the S x S
    search windows (inside the image); T/Ix/Iy: [K, win, win] template and
    gradients; q0: [K, 2] top-left patch corners in window coordinates.
    Returns (q_fin [K, 2], err [K]), the contract of
    ``klt._lk_iterate_scan``.
    """
    H, W = img.shape
    K, win, _ = T.shape
    assert win <= PATCH, win
    f32 = jnp.float32
    kern = functools.partial(_lk_kernel, W=W, win=win, S=S, iters=iters,
                             eps=float(eps))
    qx, qy, err = pl.pallas_call(
        kern,
        grid=(K,),
        out_shape=[jax.ShapeDtypeStruct((K,), f32)] * 3,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        backend="triton",
        name="klt_lk_iterate",
    )(img.reshape(-1).astype(f32), o[:, 0].astype(jnp.int32),
      o[:, 1].astype(jnp.int32), q0[:, 0].astype(f32), q0[:, 1].astype(f32),
      T.reshape(-1).astype(f32), Ix.reshape(-1).astype(f32),
      Iy.reshape(-1).astype(f32))
    return jnp.stack([qx, qy], axis=-1), err
