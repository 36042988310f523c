"""Multi-host launch and cross-host sharding (SURVEY.md §2.3 last row).

The reference is strictly single-process; this module is the from-scratch
scale-out path: ``jax.distributed.initialize()`` + per-host frame/window
shards + a (host, win) mesh whose collectives span processes. On a
cluster the 'host' axis maps across hosts and the 'win' axis across each
host's local devices; the SAME code runs multi-process
CPU for CI (see ``tests/test_multihost.py``, which drives 2 processes x 4
virtual devices through this module).

Launch pattern (per host)::

    from epivo_tpu.parallel import multihost
    multihost.initialize(coordinator, num_processes=N, process_id=i)
    mesh = multihost.host_mesh()                 # (host, win) global mesh
    lo, hi = multihost.host_window_range(W_global)
    # load/extract ONLY windows [lo, hi) on this host ...
    gl = multihost.global_window_arrays(mesh, T0s_local, p_local, ...)
    step = dist.distributed_ba_step(multihost.fold_win_mesh(mesh), spec, cfg)
    out = step(*gl)   # collectives cross hosts; result replicated
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """``jax.distributed.initialize`` with env-var fallbacks.

    Env fallbacks (standard cluster-launcher style): EPIVO_COORDINATOR,
    EPIVO_NUM_PROCESSES, EPIVO_PROCESS_ID.
    """
    kwargs = {}
    coord = coordinator_address or os.environ.get("EPIVO_COORDINATOR")
    if coord:
        kwargs["coordinator_address"] = coord
    npro = num_processes or os.environ.get("EPIVO_NUM_PROCESSES")
    if npro is not None:
        kwargs["num_processes"] = int(npro)
    pid = process_id if process_id is not None else os.environ.get(
        "EPIVO_PROCESS_ID")
    if pid is not None:
        kwargs["process_id"] = int(pid)
    jax.distributed.initialize(**kwargs)


def host_mesh(axis_names=("host", "win")) -> Mesh:
    """Global (host, win) mesh: first axis across processes, second across
    each process's local devices. Device order follows ``jax.devices()``,
    which groups by process."""
    n_proc = jax.process_count()
    n_local = jax.local_device_count()
    devs = np.array(jax.devices()).reshape(n_proc, n_local)
    return Mesh(devs, axis_names)


def fold_win_mesh(mesh: Mesh) -> Mesh:
    """Collapse a (host, win) mesh into a flat ('win',) mesh over the same
    devices, for single-axis consumers (e.g. ``dist.distributed_ba_step``).
    Cross-host collectives still happen — the device array spans hosts."""
    return Mesh(mesh.devices.reshape(-1), ("win",))


def host_window_range(n_windows: int,
                      process_id: int | None = None,
                      num_processes: int | None = None) -> tuple[int, int]:
    """[lo, hi) window range owned by this host (contiguous block split,
    remainder to the front hosts) — per-host data loading of disjoint
    shards, SURVEY §2.3."""
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    base = n_windows // n
    extra = n_windows % n
    lo = pid * base + min(pid, extra)
    hi = lo + base + (1 if pid < extra else 0)
    return lo, hi


def global_window_arrays(mesh: Mesh, *local_arrays):
    """Assemble process-local window shards into global sharded arrays.

    Each local array's leading axis is this host's window block
    (``host_window_range``); the returned jax.Arrays have the GLOBAL window
    axis sharded over every device of ``mesh`` (host-major order, matching
    the block split). Uses ``jax.make_array_from_process_local_data``."""
    flat = mesh.devices.reshape(-1)
    sharding = NamedSharding(Mesh(flat, ("win",)), P("win"))
    out = []
    for a in local_arrays:
        a = np.asarray(a)
        out.append(jax.make_array_from_process_local_data(sharding, a))
    return tuple(out)


def _test_worker(process_id: int, num_processes: int, port: int,
                 out_path: str) -> None:
    """2-process CPU validation worker (driven by tests/test_multihost.py).

    Builds a (host, win) mesh spanning both processes, runs a psum across
    ALL devices (cross-process collective), then a window-sharded BA step
    where each host supplies only its own window block, and writes the
    replicated results for the parent to compare."""
    import json

    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    initialize(coordinator_address=f"localhost:{port}",
               num_processes=num_processes, process_id=process_id)
    assert jax.process_count() == num_processes
    mesh = host_mesh()
    n_total = mesh.devices.size

    # --- cross-host psum over every device -------------------------------
    from jax import shard_map

    def summed(x):
        return jax.lax.psum(x, ("host", "win"))

    xs = jnp.arange(n_total, dtype=jnp.float32)
    got = jax.jit(
        shard_map(summed, mesh=mesh, in_specs=P(("host", "win")),
                  out_specs=P(), check_vma=False)
    )(xs)
    total = float(np.asarray(got)[0] if np.ndim(got) else got)
    expect = float(xs.sum())

    # --- cross-host window-sharded BA step -------------------------------
    from epivo_tpu.datasets import synthetic
    from epivo_tpu.parallel import dist
    from epivo_tpu.pipeline import ba
    from epivo_tpu.pipeline.config import BAConfig, LMConfig

    spec = ba.mono_window_spec(ws=3)
    cfg = BAConfig(lm=LMConfig(n_points=8, huber_delta=1.0, max_iters=5,
                               revert_r_norm=10.0))
    W_global = n_total  # one window per device
    lo, hi = host_window_range(W_global)
    # Every host could generate all windows (same keys), but loads ONLY its
    # block — the per-host disjoint data loading pattern.
    keys = jax.random.split(jax.random.PRNGKey(3), W_global)
    scenes = [
        synthetic.gen_scene_sequence(
            keys[w], N=8, n_zeta=spec.n_zeta,
            reps=[tuple(r) for r in spec.reps],
        )
        for w in range(lo, hi)
    ]
    T0s = np.stack([np.asarray(s.T0s) for s in scenes])
    pp = np.stack([np.asarray(s.p) for s in scenes])
    pt = np.stack([np.asarray(s.p_t) for s in scenes])
    wreps = np.ones((hi - lo, spec.reps.shape[0]), np.float32)
    pmask = np.ones((hi - lo, spec.reps.shape[0], 8), bool)

    g_T0s, g_p, g_pt, g_w, g_m = global_window_arrays(
        mesh, T0s, pp, pt, wreps, pmask)
    step = dist.distributed_ba_step(fold_win_mesh(mesh), spec, cfg)
    out = step(g_T0s, g_p, g_pt, g_w, g_m)
    jax.block_until_ready(out.trajectory)
    traj = np.asarray(out.trajectory)  # replicated -> same on every host

    with open(out_path, "w") as f:
        json.dump({
            "process": process_id,
            "n_devices": n_total,
            "psum": total,
            "psum_expect": expect,
            "global_r_norm": float(out.global_r_norm),
            "traj_sum": float(traj.sum()),
            "traj_finite": bool(np.all(np.isfinite(traj))),
            "traj_shape": list(traj.shape),
        }, f)


if __name__ == "__main__":
    import sys

    _test_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                 sys.argv[4])
