"""Stage profiling: the cpu_profile / render-stats analog.

The reference wraps wavefront stages in compile-time-gated timing counters
(cpu_profile, src/core/cpu_common.impala:11-24) and prints per-stage
percentages + total rays at exit (render/mapping_cpu.impala:453-472).
One render iteration is one fused device program, so the equivalent is host-side wall timers around blocking device calls
plus ray/sample accounting, with the same percentage report. jax.profiler
traces remain available for op-level analysis (jax.profiler.trace).
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class StageProfiler:
    """Accumulates wall time per stage and ray/sample counts.

    enabled=False makes every call a no-op (the reference's
    cpu_profiling_enabled static).
    """

    def __init__(self, enabled=True, unit="Mrays"):
        self.enabled = enabled
        self.unit = unit  # label for the throughput line (Mrays/Msamples)
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self.rays = 0

    @contextmanager
    def stage(self, name, block=None):
        """Times a stage. Pass block=array to block on device completion
        so the measurement covers the actual device work."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if block is not None:
            import jax
            jax.block_until_ready(block)
        self.times[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def add(self, name, seconds):
        """Record an externally-timed stage (e.g. a loop that already
        blocks on device completion for its own throughput stats)."""
        if self.enabled:
            self.times[name] += seconds
            self.counts[name] += 1

    def add_rays(self, n):
        if self.enabled:
            self.rays += int(n)

    def report(self):
        """Per-stage percentage report (render/mapping_cpu.impala:453-472
        output shape)."""
        total = sum(self.times.values())
        lines = []
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total > 0 else 0.0
            lines.append(f"{name}: {t * 1e3:.1f} ms ({pct:.1f}%), "
                         f"{self.counts[name]} calls")
        if self.rays and total > 0:
            lines.append(f"total: {total * 1e3:.1f} ms, "
                         f"{self.rays * 1e-6 / total:.2f} {self.unit}/s")
        return "\n".join(lines)
