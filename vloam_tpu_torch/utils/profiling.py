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

On the card a host span around a replayed CUDA graph times only the launch.
``device_span(name, device)`` times the card's work instead: two CUDA timing
events on the current stream around the block (none inside a capture), read
without a synchronisation once a later stage or span of the same timer
closes after the card has passed both, and recorded into that timer as
``dev.<name>``.  The driver's ``wait.fetch`` waits for the whole frame, so
each frame's pairs are read within the frame.
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
    timer._add(name, (t1 - t0) * 1e-6)
    timer.timeline.append((name, w0, w1))
    if timer.pending:
        timer._read_device_spans()


class StageTimer:
    def __init__(self):
        self.total_ms = defaultdict(float)
        self.count = defaultdict(int)
        self.max_ms = defaultdict(float)
        self.parent = {}   # name -> the stage or span it first ran in (None: a stage)
        self.timeline = deque(maxlen=TIMELINE_LEN)
        self.pending = []  # (name, start event, end event) of device spans not yet read

    def _add(self, name: str, ms: float) -> None:
        self.total_ms[name] += ms
        self.count[name] += 1
        self.max_ms[name] = max(self.max_ms[name], ms)

    def _read_device_spans(self) -> None:
        """Record the device spans whose end event the card has passed
        (``query`` does not synchronise); keep the others pending."""
        left = []
        for name, start, end in self.pending:
            if end.query():
                self._add(name, start.elapsed_time(end))
            else:
                left.append((name, start, end))
        self.pending = left

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


@contextlib.contextmanager
def device_span(name: str, device):
    """The card's time for the work the block puts on ``device``'s current
    stream, recorded as ``dev.<name>`` into the innermost stage's timer once
    the card has passed it (see the module's docstring).  Nothing on a CPU
    device, with no stage open, or inside a CUDA graph capture."""
    stack = _stack()
    dev = torch.device(device)
    if not stack or dev.type != "cuda" or torch.cuda.is_current_stream_capturing():
        yield
        return
    timer, parent = stack[-1]
    stream = torch.cuda.current_stream(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(stream)
    yield
    end.record(stream)
    timer.parent.setdefault(f"dev.{name}", parent)
    timer.pending.append((f"dev.{name}", start, end))
