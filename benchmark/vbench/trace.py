"""What the benchmark reads from a ``torch.profiler`` trace: the device's
operations (kernels, copies, fills) as intervals, and the host ranges that
``StageTimer`` opens (``record_function``), on the profiler's one clock.

The arithmetic (union of intervals, idle gaps, sums by name) is in
``arith``; this module only turns the profiler's events into plain tuples,
so the metrics' readers and the tests work on canned traces alike.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from vbench import arith

# what runs on the device: kernels, copies and fills (not the GPU-side
# shadows of record_function ranges, "gpu_user_annotation")
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the host ranges of VloamDriver's StageTimer, which name an idle gap
HOST_RANGES = ("host_grid", "host_buckets", "host_lf_voxel", "vloam_step", "host_f64_chain")


def _kind(ev) -> str:
    """The event's activity: ``activity_type()`` where PyTorch has it, else
    told apart by device and by whether it is a ``record_function`` range
    (whose GPU-side shadow carries the range's name)."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    user = ev.is_user_annotation() if hasattr(ev, "is_user_annotation") else False
    user = user or ev.name() in HOST_RANGES
    if str(ev.device_type()).endswith("CPU"):
        return "user_annotation" if user else "cpu_op"
    return "gpu_user_annotation" if user else "kernel"


@dataclass
class Trace:
    device_ops: list = field(default_factory=list)   # (name, start_ns, end_ns)
    ranges: list = field(default_factory=list)       # (name, start_ns, end_ns) host ranges
    span_ns: tuple = (0, 0)                           # the traced window on the trace's clock

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        ops, ranges = [], []
        t_min, t_max = None, None
        for ev in prof.profiler.kineto_results.events():
            start, end = ev.start_ns(), ev.end_ns()
            t_min = start if t_min is None else min(t_min, start)
            t_max = end if t_max is None else max(t_max, end)
            kind = _kind(ev)
            if kind in DEVICE_ACTIVITIES and end > start:
                ops.append((ev.name(), start, end))
            elif kind == "user_annotation" and ev.name() in HOST_RANGES:
                ranges.append((ev.name(), start, end))
        return cls(ops, ranges, (t_min or 0, t_max or 0))

    def window_s(self) -> float:
        return (self.span_ns[1] - self.span_ns[0]) * 1e-9

    def busy_s(self) -> float:
        return arith.union_length([(s, e) for _, s, e in self.device_ops]) * 1e-9

    def top_ops(self, n: int = 10, width: int = 160) -> list:
        """[[name, seconds], ...]: the device operations that took most time,
        each name cut to ``width`` characters."""
        return [[name[:width], ns * 1e-9]
                for name, ns in arith.sum_by_name(self.device_ops)[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[host ranges open at the gap's middle, seconds], ...]: the longest
        stretches with no device operation, named by the StageTimer ranges
        open on any thread at their middle ("none" where none was)."""
        gaps = arith.gaps([(s, e) for _, s, e in self.device_ops], *self.span_ns)
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = 0.5 * (s + e)
            names = sorted({name for name, a, b in self.ranges if a <= mid < b})
            out.append(["+".join(names) or "none", (e - s) * 1e-9])
        return out
