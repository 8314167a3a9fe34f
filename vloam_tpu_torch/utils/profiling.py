"""Per-stage timing (port of ``vloam_tpu/utils/profiling.StageTimer``) and
the spans inside the stages.

A StageTimer collects VloamDriver's per-stage wall-clock breakdown as running
statistics, and wraps each stage in ``torch.profiler.record_function`` so a
profiler timeline carries the same names.  ``span(name)`` does the same for
code that holds no timer (the layers inside ``vloam_step``, the host's waits
for the card): it records into the innermost stage open on the calling
thread, and with none open it only opens the ``record_function`` range.

Every stage and span also lands on its timer's ``timeline``, a bounded deque
of (name, start_ns, end_ns).  The stamps are ``time.time_ns()``, the clock
the profiler converts its events to, taken next to the range's own stamps
(the start just after the range opens, the end just after it closes), so a
reader can lay the timeline over a device trace and say what the host was
doing in each of the card's idle gaps.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict, deque

import torch

# spans a timer's timeline keeps: a 50 s window at ~15 spans a frame up to
# ~85 frames/s, the oldest dropped beyond that
TIMELINE_LEN = 1 << 16

_open = threading.local()   # .stack: the (timer, name) of the stages and spans open


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


@contextlib.contextmanager
def _timed(timer: "StageTimer", name: str, stack: list):
    parent = stack[-1][1] if stack and stack[-1][0] is timer else None
    timer.parent.setdefault(name, parent)
    stack.append((timer, name))
    try:
        with torch.profiler.record_function(name):
            w0, t0 = time.time_ns(), time.perf_counter_ns()
            yield
        t1, w1 = time.perf_counter_ns(), time.time_ns()
    finally:
        stack.pop()
    dt = (t1 - t0) * 1e-6
    timer.total_ms[name] += dt
    timer.count[name] += 1
    timer.max_ms[name] = max(timer.max_ms[name], dt)
    timer.timeline.append((name, w0, w1))


class StageTimer:
    def __init__(self):
        self.total_ms = defaultdict(float)
        self.count = defaultdict(int)
        self.max_ms = defaultdict(float)
        self.parent = {}   # name -> the stage or span it first ran in (None: a stage)
        self.timeline = deque(maxlen=TIMELINE_LEN)

    def stage(self, name: str):
        return _timed(self, name, _stack())

    def summary(self) -> str:
        """One line a stage or span, each span indented under the stage
        (or span) it ran in, in the order they first opened."""
        children = defaultdict(list)
        for name, parent in self.parent.items():
            children[parent].append(name)
        lines = []

        def walk(parent, depth):
            for name in children[parent]:
                n = self.count.get(name, 0)
                if n:
                    lines.append(
                        f"{'  ' * depth + name:<24} avg {self.total_ms[name] / n:8.2f} ms  "
                        f"max {self.max_ms[name]:8.2f} ms  n={n}")
                walk(name, depth + 1)

        walk(None, 0)
        return "\n".join(lines)


@contextlib.contextmanager
def span(name: str):
    """A named piece of the innermost stage open on this thread: timed into
    that stage's timer and its timeline, inside a ``record_function`` range.
    With no stage open, only the range."""
    stack = _stack()
    if not stack:
        with torch.profiler.record_function(name):
            yield
        return
    with _timed(stack[-1][0], name, stack):
        yield
