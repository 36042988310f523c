"""Tracing/profiling and structured metrics.

The reference's only observability is ad-hoc couts (`kitti_ba.cpp:780,
884-886,1219-1231`) and the ``LM_res`` triple. This module provides the
Equivalents promised in SURVEY.md §5: wall-clock stage timers
with device fencing, JAX profiler trace capture, and a structured JSONL
metrics sink.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

import jax


class StageTimer:
    """Accumulating per-stage wall timers with optional device fencing."""

    def __init__(self, fence: bool = True):
        self.fence = fence
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.fence and result is not None:
                jax.block_until_ready(result)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def time_fn(self, name: str, fn, *args, **kwargs):
        """Run fn, fence its output, record the stage time, return output."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.fence:
            jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        return out

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1000.0 * self.totals[k] / max(self.counts[k], 1),
            }
            for k in sorted(self.totals)
        }

    def report(self) -> str:
        lines = []
        for k, v in self.summary().items():
            lines.append(
                f"{k:24s} {v['total_s']:8.3f} s  x{v['count']:<5d}"
                f" {v['mean_ms']:9.2f} ms/call"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(out_dir: str):
    """Capture a jax.profiler trace (viewable in TensorBoard/Perfetto)."""
    os.makedirs(out_dir, exist_ok=True)
    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class MetricsLogger:
    """Structured per-window/per-frame metrics -> JSONL (SURVEY.md §5)."""

    def __init__(self, path: str | None):
        self.path = path
        self._f = open(path, "a") if path else None

    def log(self, record: dict[str, Any]) -> None:
        rec = {k: _jsonable(v) for k, v in record.items()}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


def _jsonable(v):
    import numpy as np

    if isinstance(v, (jax.Array, np.ndarray)):
        a = np.asarray(v)
        return a.item() if a.size == 1 else a.tolist()
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    return v
