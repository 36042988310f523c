"""Multi-host validation: 2 real processes x 4 virtual CPU devices.

Spawns two worker processes that jax.distributed.initialize against a
local coordinator, build a (host, win) mesh spanning both, and run
cross-process collectives (psum + window-sharded BA with a replicated
trajectory). This exercises the actual multi-process code path — the
collectives cross process boundaries over the coordination service — which
``xla_force_host_platform_device_count`` alone cannot.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "epivo_tpu", "parallel", "multihost.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_collectives(tmp_path):
    port = _free_port()
    n_proc = 2
    procs, outs = [], []
    for pid in range(n_proc):
        out_path = str(tmp_path / f"out_{pid}.json")
        outs.append(out_path)
        env = dict(os.environ)
        # The worker is launched by file path, so sys.path[0] is its own
        # directory — the repo root must be on PYTHONPATH for `epivo_tpu`.
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        log = open(str(tmp_path / f"log_{pid}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(n_proc), str(port),
             out_path],
            env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
        ), log))
    rcs = [p.wait(timeout=560) for p, _ in procs]
    for (p, log), rc, pid in zip(procs, rcs, range(n_proc)):
        log.close()
        if rc != 0:
            tail = open(str(tmp_path / f"log_{pid}.txt")).read()[-3000:]
            raise AssertionError(f"worker {pid} failed rc={rc}\n{tail}")

    results = [json.load(open(o)) for o in outs]
    for r in results:
        assert r["n_devices"] == 8  # 2 processes x 4 devices
        assert r["psum"] == r["psum_expect"]
        assert r["traj_finite"]
        assert r["traj_shape"][0] == 8 * 2 + 1  # W_global * n_zeta + 1
    # Replicated outputs agree across hosts bit-for-bit.
    assert results[0]["traj_sum"] == results[1]["traj_sum"]
    assert results[0]["global_r_norm"] == results[1]["global_r_norm"]
