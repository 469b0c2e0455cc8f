"""Profiling and runtime telemetry.

The reference's tracing is `time.perf_counter` around `select_action`
(/root/reference/scripts/run_gp_mpc.py:55-57) — wall-clock only. The
replacement (SURVEY.md §5): `jax.profiler` trace capture for per-kernel timelines,
a lightweight phase timer with the same mean/std/max semantics as the reference's
runtime stats (first sample dropped, ≙ plotting.py:10-37), and a solves/sec
counter for throughput runs.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import numpy as np


@contextlib.contextmanager
def device_trace(log_dir: str | Path):
    """Capture a jax.profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class PhaseTimer:
    """Named wall-clock phase accumulator with reference-compatible stats."""

    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def stats(self, name: str, drop_first: bool = True) -> dict:
        """mean/std/max with the warm-up sample dropped (≙ plotting.py:25)."""
        s = self.samples[name][1:] if drop_first and len(self.samples[name]) > 1 else self.samples[name]
        arr = np.asarray(s)
        return {"mean": arr.mean(), "std": arr.std(), "max": arr.max(), "n": len(arr)}

    def table(self) -> str:
        lines = [f"{'Phase':<30} {'mean (s)':>10} {'max (s)':>10} {'n':>5}"]
        for name in self.samples:
            st = self.stats(name)
            lines.append(f"{name:<30} {st['mean']:>10.4f} {st['max']:>10.4f} {st['n']:>5}")
        return "\n".join(lines)


class SolveCounter:
    """Aggregate solves/sec across timed windows (the bench headline metric)."""

    def __init__(self):
        self.solves = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def window(self, n_solves: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.solves += n_solves

    @property
    def solves_per_sec(self) -> float:
        return self.solves / self.seconds if self.seconds > 0 else 0.0
