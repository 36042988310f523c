"""Distributed pipeline steps: sharded windowed BA and pod-scale RANSAC.

From-scratch distributed layer (the reference is single-process,
SURVEY.md §2.3). Two patterns:

1. **Sharded windowed BA** (:func:`distributed_ba_step`): the window axis is
   data-parallel; each device solves its windows' LM systems locally, then
   global health metrics reduce over the mesh (XLA inserts the psum), and
   the global trajectory is stitched with a sharded associative scan over
   4x4 pose products — the collective-permute ladder is XLA's.

2. **Pod-scale RANSAC** (:func:`distributed_ransac_essential`): hypotheses
   shard over the ``hyp`` axis via ``shard_map``; each device scores its
   shard against the (replicated, small) match set; a single
   argmax-by-score collective picks the global winner.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from epivo_tpu import ransac as ransac_mod
from epivo_tpu.geometry import essential, se3
from epivo_tpu.optim import lm
from epivo_tpu.pipeline import ba
from epivo_tpu.pipeline.config import BAConfig


class DistBAResult(NamedTuple):
    T_opt: jnp.ndarray  # [W, Z, 4, 4] optimized poses (sharded over win)
    trajectory: jnp.ndarray  # [W*Z + 1, 4, 4] stitched global trajectory
    global_r_norm: jnp.ndarray  # [] cross-device residual norm
    reverted_frac: jnp.ndarray  # [] fraction of reverted windows
    r_norm: jnp.ndarray  # [W] per-window residual norms (sharded over win)
    reverted: jnp.ndarray  # [W] per-window revert flags (sharded over win)
    n_accepted: jnp.ndarray  # [W] per-window LM accepted counts


def distributed_ba_step(
    mesh: Mesh,
    spec: ba.WindowSpec,
    config: BAConfig,
):
    """Build a jitted distributed windowed-BA step for the given mesh.

    Returns fn(T0s [W,Z,4,4], p [W,R,N,3], p_t, wreps [W,R], pmask
    [W,R,N]) -> DistBAResult with W sharded over the 'win' mesh axis.
    This is the same solve the single-device drivers run
    (:func:`ba.ba_windows`); the sequence runners route through it when
    given a ``mesh`` (the reference's driver IS its pipeline,
    `kitti_ba.cpp:1071-1167` — here the distributed framework and the
    framework are the same code path).
    """
    win_s = NamedSharding(mesh, P("win"))
    rep_s = NamedSharding(mesh, P())

    def step(T0s, p, p_t, wreps, pmask):
        out = ba.ba_windows(T0s, spec, p, p_t, wreps=wreps, pmask=pmask,
                            config=config)
        # Global reductions across the sharded window axis (psum under SPMD).
        global_r = jnp.sqrt(jnp.sum(out.r_norm**2))
        rev_frac = jnp.mean(out.reverted.astype(T0s.dtype))
        # Trajectory stitch: prefix products of inverses over the global
        # zeta chain — associative scan shards over 'win' and exchanges
        # boundary poses (the ring/halo pattern for the trajectory axis).
        zetas = ba.stitch_windows(out.T_opt)
        inv = se3.inverse(zetas)
        prefix = jax.lax.associative_scan(
            lambda a, b: jnp.einsum("...ij,...jk->...ik", a, b), inv
        )
        traj = jnp.concatenate(
            [jnp.eye(4, dtype=zetas.dtype)[None], prefix], axis=0
        )
        return DistBAResult(
            T_opt=out.T_opt,
            trajectory=traj,
            global_r_norm=global_r,
            reverted_frac=rev_frac,
            r_norm=out.r_norm,
            reverted=out.reverted,
            n_accepted=out.n_accepted,
        )

    return jax.jit(
        step,
        in_shardings=(win_s, win_s, win_s, win_s, win_s),
        out_shardings=DistBAResult(
            T_opt=win_s, trajectory=rep_s, global_r_norm=rep_s,
            reverted_frac=rep_s, r_norm=win_s, reverted=win_s,
            n_accepted=win_s,
        ),
    )


def distributed_ransac_essential(
    mesh: Mesh,
    n_hyp_per_device: int = 256,
    threshold: float = 1e-5,
):
    """Build a jitted pod-scale RANSAC: hypotheses sharded over 'hyp'.

    Returns fn(key, p [N,3], p_t [N,3], mask [N]) -> (E [3,3], inliers [N]).
    Matches are replicated (small); each device solves and scores its own
    hypothesis shard; one collective argmax selects the winner.
    """
    from jax import shard_map

    n_dev = mesh.shape["hyp"]

    def per_shard(k, pp, pt, m):
        # k: [1] this device's PRNG key shard.
        res = ransac_mod.ransac_essential(
            k[0], pp, pt, n_hyp=n_hyp_per_device, threshold=threshold,
            mask=m, refit=False,
        )
        # Collective winner selection across the hyp axis.
        scores = jax.lax.all_gather(res.best_score, "hyp")  # [D]
        Es = jax.lax.all_gather(res.E, "hyp")  # [D, 3, 3]
        best = jnp.argmax(scores)
        E_best = Es[best]
        inl = (essential.sampson_error(E_best, pp, pt) < threshold) & m
        return E_best, inl

    def step(key, p, p_t, mask):
        keys = jax.random.split(key, n_dev)  # [D] typed keys
        return shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P("hyp"), P(), P(), P()),
            out_specs=(P(), P()),
            check_vma=False,
        )(keys, p, p_t, mask)

    return jax.jit(step)
