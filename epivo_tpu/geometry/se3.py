"""Batched SE(3) / SO(3) operations (pure JAX, fixed shapes).

Replacement for the reference's Sophus usage
(`/root/reference/jac_Rt_gen_.cpp:419` ``Sophus::SE3<double>::exp``,
`/root/reference/sequence.hpp:14-21` rotation generation). Everything is
written as closed-form, branch-free tensor math so it batches with ``vmap``
and fuses under ``jit``. Poses are 4x4 homogeneous matrices with arbitrary
leading batch dimensions.

Tangent-vector convention matches Sophus/the reference
(`jac_Rt_gen_.cpp:29-32`): ``xi = (v, w)`` — translation first, rotation
second.
"""

from __future__ import annotations

import jax.numpy as jnp

# Small-angle cutoff: below this, Taylor expansions are used. Chosen so that
# theta**2 is still well above f32 underflow while the expansion error is
# below f32 epsilon.
_EPS = 1e-6


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], axis=-1),
            jnp.stack([wz, zeros, -wx], axis=-1),
            jnp.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`hat`: [..., 3, 3] -> [..., 3]."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sinc_coeffs(theta2: jnp.ndarray):
    """Return (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3).

    Branch-free small-angle handling: Taylor series below the cutoff.
    """
    theta = jnp.sqrt(theta2)
    small = theta2 < _EPS
    # Guard the denominators; the guarded lanes are overwritten by `where`.
    safe_t2 = jnp.where(small, jnp.ones_like(theta2), theta2)
    safe_t = jnp.sqrt(safe_t2)
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(safe_t) / safe_t)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(safe_t)) / safe_t2)
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (safe_t - jnp.sin(safe_t)) / (safe_t2 * safe_t))
    return A, B, C


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    theta2 = jnp.sum(w * w, axis=-1)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Log map of SO(3): [..., 3, 3] -> [..., 3] axis-angle.

    Branch-free; accurate away from theta = pi (sufficient for VO increments,
    which the reference also assumes — its motions are bounded by pi/6 per
    axis, `sequence.hpp:16-20`).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    w_vee = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5  # = sin(theta) * axis
    sin_theta = jnp.sin(theta)
    small = theta < 1e-4
    safe_sin = jnp.where(small, jnp.ones_like(sin_theta), sin_theta)
    # theta/sin(theta) -> 1 + theta^2/6 for small theta
    factor = jnp.where(small, 1.0 + theta * theta / 6.0, theta / safe_sin)
    return w_vee * factor[..., None]


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """SE(3) exponential: [..., 6] (v, w) -> [..., 4, 4].

    T = [[exp(w), V v], [0, 1]] with V the left Jacobian of SO(3).
    """
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)
    A, B, C = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    t = jnp.einsum("...ij,...j->...i", V, v)
    return rt_to_matrix(R, t)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """SE(3) log map: [..., 4, 4] -> [..., 6] (v, w)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = jnp.sum(w * w, axis=-1)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    small = theta2 < _EPS
    safe_t2 = jnp.where(small, jnp.ones_like(theta2), theta2)
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - A / (2.0 * B)) / safe_t2,
    )
    V_inv = eye - 0.5 * W + coef[..., None, None] * W2
    v = jnp.einsum("...ij,...j->...i", V_inv, t)
    return jnp.concatenate([v, w], axis=-1)


def rt_to_matrix(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Assemble [..., 4, 4] homogeneous transforms from R [...,3,3], t [...,3]."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def matrix_to_rt(T: jnp.ndarray):
    """Split [..., 4, 4] -> (R [...,3,3], t [...,3])."""
    return T[..., :3, :3], T[..., :3, 3]


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form SE(3) inverse (never a linear solve)."""
    R, t = matrix_to_rt(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return rt_to_matrix(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def identity(batch_shape=(), dtype=jnp.float32) -> jnp.ndarray:
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), tuple(batch_shape) + (4, 4))


def mul44(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched 4x4 matrix product as broadcast-multiply + sum.

    Used in place of ``@`` inside the batched windowed-BA solve, where the
    tiny ``dot_general`` sits under nested vmap + scan; mul+sum is plain
    elementwise work on any backend (ROADMAP C3 reviews whether it stays).
    """
    return jnp.sum(a[..., :, :, None] * b[..., None, :, :], axis=-2)


def generators(dtype=jnp.float32) -> jnp.ndarray:
    """The 6 generators of se(3) as a [6, 4, 4] tensor.

    Order (v, w) matching :func:`se3_exp`. These are the same generator
    matrices the reference builds column-by-column at
    `jac_Rt_gen_.cpp:46-89`; here they are one constant tensor so the
    per-generator products become a single batched einsum.
    """
    G = jnp.zeros((6, 4, 4), dtype=dtype)
    # Translation generators: d/de [exp(e * G_k)] = e_k in last column.
    G = G.at[0, 0, 3].set(1.0)
    G = G.at[1, 1, 3].set(1.0)
    G = G.at[2, 2, 3].set(1.0)
    # Rotation generators: hat(e_k) in the top-left 3x3 block.
    e = jnp.eye(3, dtype=dtype)
    G = G.at[3, :3, :3].set(hat(e[0]))
    G = G.at[4, :3, :3].set(hat(e[1]))
    G = G.at[5, :3, :3].set(hat(e[2]))
    return G


def chain_compose(Ts: jnp.ndarray, reverse: bool = False) -> jnp.ndarray:
    """Compose a chain of transforms: returns T[n-1] @ ... @ T[0].

    Equivalent to the reference's trajectory accumulation loops
    (`jac_Rt_gen_.cpp:432-440`). ``Ts`` is [n, 4, 4].
    """
    import jax

    def step(carry, T):
        out = T @ carry if not reverse else carry @ T
        return out, None

    init = jnp.eye(4, dtype=Ts.dtype)
    final, _ = jax.lax.scan(step, init, Ts)
    return final


def prefix_products(Ts: jnp.ndarray) -> jnp.ndarray:
    """All contiguous sub-chain products of a pose chain.

    ``out[j, k] = Ts[k] @ Ts[k-1] @ ... @ Ts[j]`` for ``j <= k``;
    entries with ``j > k`` are identity. This is the fixed-shape equivalent
    of the reference's mutable prefix cache ``T0_mem``
    (`jac_Rt_gen_.cpp:18-20,327-335`), recomputed functionally each LM
    iteration. ``Ts`` is [Z, 4, 4]; output is [Z, Z, 4, 4].

    Cost is O(Z^2) 4x4 matmuls — negligible for window sizes (Z <= 16) and
    fully batched via a vmapped scan.
    """
    import jax

    Z = Ts.shape[0]
    eye = jnp.eye(4, dtype=Ts.dtype)

    def row(j):
        def step(carry, k):
            # carry holds Ts[k-1]...Ts[j] (or I while k < j)
            new = jnp.where(k == j, Ts[k], jnp.where(k > j, Ts[k] @ carry, eye))
            return new, new

        _, outs = jax.lax.scan(step, eye, jnp.arange(Z))
        return outs  # [Z, 4, 4]

    return jax.vmap(row)(jnp.arange(Z))
