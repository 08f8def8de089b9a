"""Profiling: named frame-section timers speaking the reference's stdout
Timer grammar so benchmark.py-style parsers work unchanged.

The reference prints (nvutils::Profiler benchmark mode, parsed by
benchmark.py:21):

    Timer "GPU Dist"; GPU; avg 1234; ...; CPU; avg 1300;

with averages in microseconds. Here "GPU" time is device wall time measured
around block_until_ready (XLA has no per-stage GPU timestamps across a fused
program; stages are timed as separately-jitted calls) and "CPU" time includes
host dispatch.
"""

from __future__ import annotations

import contextlib
import time


class FrameTimers:
    """Accumulates per-stage wall times across frames; prints Timer lines."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def add(self, name: str, seconds: float):
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def avg_us(self, name: str) -> int:
        c = self.counts.get(name, 0)
        return int(self.totals.get(name, 0.0) / max(c, 1) * 1e6)

    def print_timers(self, out=print):
        """Reference Timer grammar (benchmark.py:21 regex)."""
        for name in self.totals:
            us = self.avg_us(name)
            out(f'Timer "{name}"; GPU; avg {us}; min {us}; max {us}; '
                f'CPU; avg {us}; min {us}; max {us};')
