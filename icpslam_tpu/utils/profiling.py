"""Tracing / profiling — the observability the reference never had
(SURVEY.md §5.1: no timers anywhere in the reference tree).

Two mechanisms:
- ``StageTimer``: lightweight host-side wall-clock accumulation per named
  pipeline stage (blocks on device results, so timings are honest)
- ``trace()``: context manager around ``jax.profiler`` for full XLA/GPU
  traces viewable in TensorBoard/Perfetto, plus ``annotate()`` for named
  trace regions inside host loops
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax


class StageTimer:
    """Accumulate wall-clock per stage; blocks until device work finishes."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def time_stage(self, name: str, fn, *args, **kwargs):
        """Run fn, block on its result, and record the stage time."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1
        return out

    def summary(self) -> Dict[str, dict]:
        return {
            k: {
                "total_s": round(self.totals[k], 6),
                "count": self.counts[k],
                "mean_ms": round(1000.0 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in sorted(self.totals)
        }

    def report(self) -> str:
        lines = [f"{'stage':30s} {'calls':>6s} {'mean ms':>10s} {'total s':>9s}"]
        for k, v in self.summary().items():
            lines.append(
                f"{k:30s} {v['count']:6d} {v['mean_ms']:10.3f} {v['total_s']:9.3f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace (TensorBoard / Perfetto readable)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region in the profiler timeline (host-side spans)."""
    return jax.profiler.TraceAnnotation(name)
