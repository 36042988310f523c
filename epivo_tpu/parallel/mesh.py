"""Device-mesh utilities for SPMD scale-out.

The reference has no distributed layer at all (SURVEY.md §2.3); this module
is the from-scratch equivalent: a mesh over devices/hosts, with
named axes for the framework's parallelism dimensions:

- ``win``  — window/data parallelism: independent BA windows sharded across
             devices (the dominant axis; maps to DP).
- ``hyp``  — RANSAC hypothesis parallelism: minimal-sample solves sharded
             across devices with a collective argmax (maps to TP-style
             compute sharding).

Trajectory stitching across the sharded window axis uses XLA's collective
machinery via sharded associative scan (the SP/ring-halo analogue for the
"sequence = trajectory" axis, SURVEY.md §5).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_win: int | None = None, n_hyp: int = 1, devices=None) -> Mesh:
    """Build a (win, hyp) mesh. Defaults to all devices on the win axis."""
    devices = devices if devices is not None else jax.devices()
    n_dev = len(devices)
    if n_win is None:
        n_win = n_dev // n_hyp
    assert n_win * n_hyp == n_dev, (n_win, n_hyp, n_dev)
    arr = np.asarray(devices).reshape(n_win, n_hyp)
    return Mesh(arr, axis_names=("win", "hyp"))


def win_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a leading window/batch axis over the 'win' mesh axis."""
    return NamedSharding(mesh, P("win"))


def hyp_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a leading hypothesis axis over the 'hyp' mesh axis."""
    return NamedSharding(mesh, P("hyp"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
