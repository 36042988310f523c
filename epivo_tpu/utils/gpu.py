"""Helpers for the programs that run on the card (``chip_smoke.py``,
``bench.py``, ``scripts/time_lk_kernel.py``): the device check, the card's
name and power limit, fenced wall-clock timing, and the switch that
traces ``klt`` with a chosen LK iteration loop for A/B checks.

Importing this module changes no JAX setting.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import jax
import numpy as np


def card_info() -> str:
    """``name, power.limit`` of each card, from nvidia-smi (a child process
    that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu(n: int = 1) -> list:
    """The first ``n`` GPU devices; exits non-zero without them."""
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        print(f"needs {n} GPU device(s); JAX found {len(devs)} x "
              f"{devs[0].platform}", flush=True)
        raise SystemExit(2)
    return devs[:n]


def median_ms(fn, *args, reps: int = 10) -> float:
    """Median wall time of ``fn(*args)`` fenced with block_until_ready,
    after one warm-up call."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


@contextlib.contextmanager
def lk_loop(impl):
    """Trace ``klt`` with ``impl`` as its LK iteration loop on every
    platform. ``impl`` takes the arguments of ``klt._lk_iterate`` (for
    example ``klt._lk_iterate_scan``). Functions traced inside the block
    keep the loop they were traced with."""
    from epivo_tpu.frontend import klt

    saved = klt._lk_iterate
    klt._lk_iterate = impl
    try:
        yield
    finally:
        klt._lk_iterate = saved
