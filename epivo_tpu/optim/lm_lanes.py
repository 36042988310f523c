"""Window-last batched LM: the windowed-BA solver with the batch axis last.

``lm.solve_batched`` vmaps the reference-shaped formulation, so every
tensor carries the tiny geometric dims last — J is [W, R, N, Z, 6], dT is
[W, R, Z, 6, 4, 4], residuals [W, R, N]. This module re-expresses the SAME
solver (identical math, schedule, and masking semantics as ``lm.solve`` —
`jac_Rt_gen_.cpp:287-478` lineage) with the WINDOW axis last and the point
axis N second-to-last, so every elementwise op runs over long contiguous
[N, W] planes:

    points   [R, 3, N, W]      residuals [R, N, W]
    poses    [Z, 4, 4, W]      Jacobian blocks per (rep, zeta): [6, N, W]

Small static axes (R, Z, 6, 3) are unrolled Python loops over leading
dims — they vanish into the op count instead of the tile shape. The only
W-leading work is the damped normal solve ([W, 6Z, 6Z] batched Cholesky
via ``jnp.linalg.solve``) and the multiplicative pose update, both tiny.

Constraint spans (``reps``) must be static (numpy) here — they always are
in window specs. Forward and reverse spans are both supported.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from epivo_tpu.geometry.epipolar import (
    DEFAULT_HUBER_DELTA, _SAFE_EPS, huber, huber_deriv,
)
from epivo_tpu.optim.lm import LMResult

_G = None  # [6, 4, 4] se(3) generators, built lazily (numpy, static)


def _generators():
    global _G
    if _G is None:
        e = np.eye(3)
        G = np.zeros((6, 4, 4), np.float32)
        for k in range(3):
            G[k, k, 3] = 1.0
        for a, (i, j) in enumerate(((2, 1), (0, 2), (1, 0))):
            G[3 + a, i, j] = 1.0
            G[3 + a, j, i] = -1.0
        _G = G
    return _G


def _mul(a, b):
    """Lane-major matrix product: [..., m, k, W] x [..., k, n, W]."""
    return jnp.sum(a[..., :, :, None, :] * b[..., None, :, :, :], axis=-3)


def _inv_se3(T):
    """Lane-major SE(3) inverse of [4, 4, W]."""
    R = T[:3, :3]  # [3, 3, W]
    t = T[:3, 3]  # [3, W]
    Rt = jnp.swapaxes(R, 0, 1)
    ti = -jnp.sum(Rt * t[None, :, :], axis=1)  # [3, W]
    W = T.shape[-1]
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], T.dtype)[:, None], (4, W))
    top = jnp.concatenate([Rt, ti[:, None, :]], axis=1)  # [3, 4, W]
    return jnp.concatenate([top, bottom[None]], axis=0)


def _exp_lanes(xi):
    """Lane-major se(3) exp: xi [Z, 6, W] -> [Z, 4, 4, W].

    Same Rodrigues/V-matrix series as ``se3.se3_exp`` (order v, w).
    """
    v = xi[:, :3]  # [Z, 3, W]
    w = xi[:, 3:]  # [Z, 3, W]
    th2 = jnp.sum(w * w, axis=1)  # [Z, W]
    th = jnp.sqrt(jnp.maximum(th2, 0.0))
    small = th < 1e-5
    safe2 = jnp.where(small, 1.0, th2)
    A = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / jnp.sqrt(safe2))
    B = jnp.where(small, 0.5 - th2 / 24.0, (1.0 - jnp.cos(th)) / safe2)
    C = jnp.where(small, 1.0 / 6.0 - th2 / 120.0, (1.0 - A) / safe2)

    Z_, _, Wn = xi.shape
    zero = jnp.zeros_like(th)
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
    K = jnp.stack([
        jnp.stack([zero, -wz, wy], axis=1),
        jnp.stack([wz, zero, -wx], axis=1),
        jnp.stack([-wy, wx, zero], axis=1),
    ], axis=1)  # [Z, 3, 3, W]
    K2 = _mul(K, K)
    eye3 = jnp.broadcast_to(
        jnp.eye(3, dtype=xi.dtype)[None, :, :, None], (Z_, 3, 3, Wn))
    R = eye3 + A[:, None, None] * K + B[:, None, None] * K2
    V = eye3 + B[:, None, None] * K + C[:, None, None] * K2
    t = jnp.sum(V * v[:, None, :, :], axis=2)  # [Z, 3, W]

    top = jnp.concatenate([R, t[:, :, None, :]], axis=2)  # [Z, 3, 4, W]
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], xi.dtype)[None, :, None],
        (Z_, 4, Wn))[:, None]
    return jnp.concatenate([top, bottom], axis=1)


def _chol_solve_lanes(H, b):
    """Lane-major Cholesky solve of H x = b for [D, D, W] SPD systems.

    The unrolled recurrence is a pure elementwise chain over [W] vectors
    that XLA fuses into a handful of kernels, in place of a batched LU. The damped, floored
    H is SPD by construction; the sqrt guard keeps NaNs from non-SPD
    garbage inputs local (the accept/NaN gates reject the step anyway).
    """
    D = H.shape[0]
    L = [[None] * D for _ in range(D)]
    for i in range(D):
        for j in range(i + 1):
            s = H[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * D
    for i in range(D):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * D
    for i in range(D - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, D):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)  # [D, W]


def _prefix_mem(Ts):
    """{(j, k): Ts[k] ... Ts[j]} for j <= k; Ts [Z, 4, 4, W] (static Z)."""
    Z = Ts.shape[0]
    mem = {}
    for j in range(Z):
        acc = Ts[j]
        mem[(j, j)] = acc
        for k in range(j + 1, Z):
            acc = _mul(Ts[k], acc)
            mem[(j, k)] = acc
    return mem


def _rep_frames(mem, reps, Z, dtype, Wn):
    """Per (rep, zeta) left/right frames + composed pose, statically
    unrolled (mirrors ``lm._zeta_frames`` / `jac_Rt_gen_.cpp:262-284`)."""
    eye = jnp.broadcast_to(jnp.eye(4, dtype=dtype)[:, :, None], (4, 4, Wn))
    frames = []  # list over reps: (T0r, [(k, Tl, Tr, sign)])
    for z0, z1 in reps:
        z0, z1 = int(z0), int(z1)
        if z0 <= z1:
            T0r = mem[(z0, z1)]
            ks = []
            for k in range(z0, z1 + 1):
                Tl = mem[(k, z1)]
                Tr = mem[(z0, k - 1)] if k > z0 else eye
                ks.append((k, Tl, Tr, 1.0))
        else:
            T0r = _inv_se3(mem[(z1, z0)])
            ks = []
            for k in range(z1, z0 + 1):
                Tl = _inv_se3(mem[(z1, k)])
                Tr = _inv_se3(mem[(k + 1, z0)]) if k < z0 else eye
                ks.append((k, Tl, Tr, -1.0))
        frames.append((T0r, ks))
    return frames


def _point_terms(T0r, pT, xq, yq):
    """Shared per-point quantities, lane-major, with arbitrary leading
    batch dims (e.g. the stacked constraint axis R).

    T0r [..., 4, 4, W]; pT [..., 3, N, W]; xq/yq [..., N, W].
    Returns dict of tensors shaped [..., N, W] / [..., 3, N, W].
    """
    R0 = T0r[..., :3, :3, :]  # [..., 3, 3, W]
    t0 = T0r[..., :3, 3, :]  # [..., 3, W]
    Rp = jnp.sum(R0[..., :, :, None, :] * pT[..., None, :, :, :],
                 axis=-3)  # [..., 3, N, W]
    A0 = t0[..., 0, None, :] - xq * t0[..., 2, None, :]  # [..., N, W]
    A1 = t0[..., 1, None, :] - yq * t0[..., 2, None, :]
    B0 = Rp[..., 0, :, :] - xq * Rp[..., 2, :, :]
    B1 = Rp[..., 1, :, :] - yq * Rp[..., 2, :, :]
    ATA = A0 * A0 + A1 * A1
    BTB = B0 * B0 + B1 * B1
    nB_ok = BTB > _SAFE_EPS * _SAFE_EPS  # matches nB > _SAFE_EPS
    # epipolar_depth: d = nA/nB where nB > eps else 0
    nA = jnp.sqrt(jnp.maximum(ATA, 0.0))
    nB = jnp.sqrt(jnp.maximum(BTB, 0.0))
    d = jnp.where(nB_ok, nA / jnp.where(nB_ok, nB, 1.0), 0.0)
    X = Rp * d[..., None, :, :] + t0[..., :, None, :]  # [..., 3, N, W]
    z = X[..., 2, :, :]
    z_ok = jnp.abs(z) > _SAFE_EPS
    inv_z = 1.0 / jnp.where(z_ok, z, 1.0)
    proj0 = X[..., 0, :, :] * inv_z
    proj1 = X[..., 1, :, :] * inv_z
    e0 = proj0 - xq
    e1 = proj1 - yq
    s = 0.5 * (e0 * e0 + e1 * e1)
    return dict(R0=R0, t0=t0, Rp=Rp, A0=A0, A1=A1, B0=B0, B1=B1,
                ATA=ATA, BTB=BTB, nA=nA, nB=nB, nB_ok=nB_ok, d=d,
                z_ok=z_ok, inv_z=inv_z, proj0=proj0, proj1=proj1,
                e0=e0, e1=e1, s=s)


def _residual_lanes(tm, huber_delta, pm):
    """Residual [..., N, W] from :func:`_point_terms` (matches
    ``epipolar.residual`` masking exactly)."""
    r = huber(tm["s"], huber_delta)
    ok = tm["nB_ok"] & tm["z_ok"]
    if pm is not None:
        ok = ok & pm
    return jnp.where(ok, r, 0.0)


def _jacobian_lanes(tm, Tl, Tr, sign, pT, xq, yq, huber_delta, pm, G):
    """Jacobian blocks [P, 6, N, W] for a STACK of (rep, zeta) pairs
    (matches ``epipolar.residual_jacobian``); all per-pair inputs carry
    the leading P axis (tm fields gathered per pair)."""
    # dT = sign * Tl G_k Tr -> [P, 6, 4, 4, W]
    Gj = jnp.asarray(G, Tl.dtype)[None, :, :, :, None]  # [1, 6, 4, 4, 1]
    dT = sign[:, None, None, None, None] * _mul(_mul(Tl[:, None], Gj),
                                                Tr[:, None])
    dR = dT[:, :, :3, :3, :]  # [P, 6, 3, 3, W]
    dt = dT[:, :, :3, 3, :]  # [P, 6, 3, W]

    # dRp[p, g, i, n, w] = sum_j dR[p, g, i, j, w] p[p, j, n, w]
    dRp = jnp.sum(dR[..., None, :] * pT[:, None, None, :, :, :], axis=-3)
    # J_A rows (P' dt): [P, 6, N, W]
    xqb = xq[:, None]  # [P, 1, N, W]
    yqb = yq[:, None]
    JA0 = dt[:, :, 0, None, :] - xqb * dt[:, :, 2, None, :]
    JA1 = dt[:, :, 1, None, :] - yqb * dt[:, :, 2, None, :]
    JB0 = dRp[:, :, 0] - xqb * dRp[:, :, 2]
    JB1 = dRp[:, :, 1] - yqb * dRp[:, :, 2]

    ok = (tm["ATA"] > _SAFE_EPS) & (tm["BTB"] > _SAFE_EPS)
    safe_ATA = jnp.where(ok, tm["ATA"], 1.0)
    safe_BTB = jnp.where(ok, tm["BTB"], 1.0)
    nA = jnp.sqrt(safe_ATA)
    nB = jnp.sqrt(safe_BTB)

    AtJA = tm["A0"][:, None] * JA0 + tm["A1"][:, None] * JA1  # [P, 6, N, W]
    BtJB = tm["B0"][:, None] * JB0 + tm["B1"][:, None] * JB1
    J_d = ((nB / nA)[:, None] * AtJA
           - (nA / nB)[:, None] * BtJB) / safe_BTB[:, None]

    # J_X = dR (p d) + dt + Rp * J_d   -> [P, 6, 3, N, W]
    d0 = (tm["nA"] / nB)[:, None, None]  # matches d0 with safe_BTB guard
    J_X = (dRp * d0 + dt[..., None, :]
           + tm["Rp"][:, None] * J_d[:, :, None])

    # e^T J_Pi (rows folded) contracted with J_X over the coordinate axis.
    g0 = tm["e0"] * tm["inv_z"]
    g1 = tm["e1"] * tm["inv_z"]
    g2 = -(tm["e0"] * tm["proj0"] + tm["e1"] * tm["proj1"]) * tm["inv_z"]
    drho = huber_deriv(tm["s"], huber_delta)
    J = drho[:, None] * (g0[:, None] * J_X[:, :, 0]
                         + g1[:, None] * J_X[:, :, 1]
                         + g2[:, None] * J_X[:, :, 2])  # [P, 6, N, W]

    good = ok & tm["z_ok"]
    if pm is not None:
        good = good & pm
    return jnp.where(good[:, None], J, 0.0)


def solve_batched_lanes(
    T0s: jnp.ndarray,
    reps: np.ndarray,
    p: jnp.ndarray,
    p_t: jnp.ndarray,
    wreps: jnp.ndarray | None = None,
    pmask: jnp.ndarray | None = None,
    zeta_mask: np.ndarray | None = None,
    lambda0: float = 1e-2,
    epsilon: float = 1e-8,
    max_iters: int = 30,
    huber_delta: float = DEFAULT_HUBER_DELTA,
) -> LMResult:
    """Drop-in lane-major equivalent of ``lm.solve_batched``.

    Args mirror ``lm.solve_batched`` (T0s [W, Z, 4, 4], p/p_t [W, R, N, 3],
    wreps [W, R], pmask [W, R, N]) except ``reps``/``zeta_mask`` must be
    static numpy arrays. Outputs are identical in layout and semantics
    (parity-tested against ``lm.solve_batched``).
    """
    reps = np.asarray(reps)
    Wn, Z = T0s.shape[0], T0s.shape[1]
    R_ = reps.shape[0]
    N = p.shape[2]
    dtype = T0s.dtype
    D = 6 * Z
    G = _generators()

    # One-time transposes into lane-major layout.
    Ts0 = jnp.transpose(T0s, (1, 2, 3, 0))  # [Z, 4, 4, W]
    pT = jnp.transpose(p, (1, 3, 2, 0))  # [R, 3, N, W]
    xq = jnp.transpose(p_t[..., 0], (1, 2, 0))  # [R, N, W]
    yq = jnp.transpose(p_t[..., 1], (1, 2, 0))
    w_l = (jnp.transpose(jnp.asarray(wreps, dtype), (1, 0))
           if wreps is not None else jnp.ones((R_, Wn), dtype))  # [R, W]
    pm_l = (jnp.transpose(pmask, (1, 2, 0)) if pmask is not None
            else None)  # [R, N, W]
    zmask = (np.ones(Z, bool) if zeta_mask is None
             else np.asarray(zeta_mask, bool))

    # Static (rep, zeta) pair list shared by every iteration.
    pair_rep, pair_zeta = [], []
    for r_i, (z0, z1) in enumerate(reps):
        lo, hi = sorted((int(z0), int(z1)))
        for k in range(lo, hi + 1):
            pair_rep.append(r_i)
            pair_zeta.append(k)
    P = len(pair_rep)
    pr_idx = np.asarray(pair_rep)

    def weighted_residuals(Ts):
        """[R, N, W] weighted residual stack + frames + stacked terms.

        One stacked :func:`_point_terms` evaluation over the constraint
        axis (the per-constraint Python loop multiplied the op count by
        R and dominated the post-Cholesky profile)."""
        mem = _prefix_mem(Ts)
        frames = _rep_frames(mem, reps, Z, dtype, Wn)
        T0r_all = jnp.stack([f[0] for f in frames])  # [R, 4, 4, W]
        tm = _point_terms(T0r_all, pT, xq, yq)
        r = _residual_lanes(tm, huber_delta, pm_l) * w_l[:, None]
        return r, frames, tm

    def energy(Ts):
        r, _, _ = weighted_residuals(Ts)
        return jnp.sqrt(jnp.sum(r * r, axis=(0, 1)))  # [W]

    def step(carry, _):
        Ts, lam, prev_E, H_norm, n_acc, done = carry
        # (Ts lane-major [Z, 4, 4, W]; lam/prev_E/... [W])

        r_stack, frames, tm = weighted_residuals(Ts)

        # All (rep, zeta) Jacobian blocks in ONE stacked evaluation.
        # (pairs_flat order matches pair_rep/pair_zeta: both enumerate
        # zetas ascending within each constraint.)
        pairs_flat = [frames[r][1][q] for r in range(R_)
                      for q in range(len(frames[r][1]))]
        assert len(pairs_flat) == P
        Tl_all = jnp.stack([pf[1] for pf in pairs_flat])
        Tr_all = jnp.stack([pf[2] for pf in pairs_flat])
        sign_all = jnp.asarray([pf[3] for pf in pairs_flat], dtype)
        tm_p = {key_: val[pr_idx] for key_, val in tm.items()}
        pm_p = None if pm_l is None else pm_l[pr_idx]
        J_all = _jacobian_lanes(tm_p, Tl_all, Tr_all, sign_all, pT[pr_idx],
                                xq[pr_idx], yq[pr_idx], huber_delta, pm_p, G)
        J_all = J_all * w_l[pr_idx][:, None, None]  # [P, 6, N, W]

        # Accumulate b and H over the (small, static) pair list.
        b = jnp.zeros((D, Wn), dtype)
        H = jnp.zeros((D, D, Wn), dtype)
        rw_p = r_stack[pr_idx]  # [P, N, W] (already weighted)
        bp = jnp.sum(J_all * rw_p[:, None], axis=2)  # [P, 6, W]
        for p_i in range(P):
            k = pair_zeta[p_i]
            b = b.at[6 * k : 6 * k + 6].add(bp[p_i])
        for p_i in range(P):
            k = pair_zeta[p_i]
            for p_j in range(P):
                if pair_rep[p_j] != pair_rep[p_i]:
                    continue  # blocks couple only within a constraint
                k2 = pair_zeta[p_j]
                if k2 < k:
                    continue
                blk = jnp.sum(J_all[p_i][:, None] * J_all[p_j][None, :],
                              axis=2)
                H = H.at[6 * k : 6 * k + 6, 6 * k2 : 6 * k2 + 6].add(blk)
                if k2 > k:
                    H = H.at[6 * k2 : 6 * k2 + 6, 6 * k : 6 * k + 6].add(
                        jnp.swapaxes(blk, 0, 1))

        # Damped normal equations (identical schedule to lm.solve), kept
        # lane-major: H [D, D, W], diag/damping elementwise over lanes.
        diag = jnp.stack([H[a, a] for a in range(D)])  # [D, W]
        h_scale = jnp.mean(diag, axis=0) + 1e-30  # [W]
        eyeD = jnp.eye(D, dtype=dtype)[:, :, None]
        H_damped = (H + lam[None, None, :] * (diag[:, None, :] * eyeD)
                    + (1e-7 * h_scale)[None, None, :] * eyeD)
        delta_l = -_chol_solve_lanes(H_damped, b)  # [D, W]

        nan_step = jnp.any(~jnp.isfinite(delta_l), axis=0)  # [W]
        small_step = jnp.sqrt(jnp.sum(delta_l * delta_l, axis=0)) < epsilon
        delta_l = jnp.where(nan_step[None], 0.0, delta_l)

        H_norm_cur = jnp.sqrt(jnp.sum(H_damped * H_damped, axis=(0, 1)))

        # Candidate poses: lane-major exp + per-zeta right multiply.
        dxi = delta_l.reshape(Z, 6, Wn)  # [Z, 6, W]
        dT = _exp_lanes(dxi)  # [Z, 4, 4, W]
        Ts_cand = _mul(Ts, dT)
        zm = jnp.asarray(zmask)[:, None, None, None]
        Ts_cand = jnp.where(zm, Ts_cand, Ts)

        cand_E = energy(Ts_cand)
        accept = (cand_E < prev_E) & ~nan_step & ~small_step & ~done

        acc_b = accept[None, None, None, :]
        Ts_new = jnp.where(acc_b, Ts_cand, Ts)
        prev_E_new = jnp.where(accept, cand_E, prev_E)
        lam_new = jnp.where(done, lam,
                            jnp.where(accept, lam / 2.0, lam * 5.0))
        done_new = done | nan_step | small_step
        n_acc_new = n_acc + accept.astype(jnp.int32)
        H_norm_new = jnp.where(done, H_norm, H_norm_cur)

        return (Ts_new, lam_new, prev_E_new, H_norm_new, n_acc_new,
                done_new), None

    carry0 = (
        Ts0,
        jnp.full((Wn,), lambda0, dtype),
        jnp.full((Wn,), jnp.inf, dtype),
        jnp.zeros((Wn,), dtype),
        jnp.zeros((Wn,), jnp.int32),
        jnp.zeros((Wn,), bool),
    )
    (Ts, lam, _, H_norm, n_acc, done), _ = jax.lax.scan(
        step, carry0, None, length=max_iters)
    final_E = energy(Ts)
    return LMResult(
        T0s=jnp.transpose(Ts, (3, 0, 1, 2)),  # [W, Z, 4, 4]
        r_norm=final_E,
        H_norm=H_norm,
        lam=lam,
        n_accepted=n_acc,
        converged=done,
    )
