"""Per-stage timing (port of ``vloam_tpu/utils/profiling.StageTimer``).

A StageTimer collects VloamDriver's per-stage wall-clock breakdown as running
statistics, and wraps each stage in ``torch.profiler.record_function`` so a
profiler timeline carries the same names.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class StageTimer:
    def __init__(self):
        self.total_ms = defaultdict(float)
        self.count = defaultdict(int)
        self.max_ms = defaultdict(float)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        dt = (time.perf_counter() - t0) * 1e3
        self.total_ms[name] += dt
        self.count[name] += 1
        self.max_ms[name] = max(self.max_ms[name], dt)

    def summary(self) -> str:
        lines = []
        for name in self.total_ms:
            n = self.count[name]
            lines.append(
                f"{name:<24} avg {self.total_ms[name] / max(n, 1):8.2f} ms  "
                f"max {self.max_ms[name]:8.2f} ms  n={n}"
            )
        return "\n".join(lines)

    def mean_ms(self, name: str) -> float:
        return self.total_ms[name] / max(self.count[name], 1)
