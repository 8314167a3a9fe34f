"""The measured window: one drive replayed through ``VloamDriver.process``
in a closed loop, in one process and one thread.

One process drives the card, and the frame loop is one Python thread: the
next frame goes in when ``process`` has returned, as a user replaying a
recorded drive feeds it.  Set-up warms up through a throw-away driver on
the drive's first frames (its first frame, steady frames and a cube
crossing: every shape and path the window takes) and opens the window's
driver.  The window then runs ``seconds``; a frame counts if ``process``
returned inside it.  When the drive's last frame has gone in inside the
window, the replay starts again from its first frame with a fresh driver,
as a user replaying the next sequence does; no frame is fed twice to one
driver.  Every driver writes its VO/LO/MO rows to files under ``out_dir``.

With ``trace_seconds`` the profiler, started in set-up, records the last
``trace_seconds`` of the window and the frame in flight when it closes, and
the k-NN pair calls of LO and MO made meanwhile are recorded with their
live counts (on the device, read after the window) for the roofline share.

Each eighth of the window is also read for where its time went (``Stretch``):
the frames that returned in it, this process's CPU seconds, its involuntary
context switches, the host's busy share over all its CPUs (``/proc/stat``,
read only) and the time the garbage collector ran.
"""

from __future__ import annotations

import contextlib
import gc
import os
import resource
import time
from dataclasses import dataclass, field
from unittest import mock

import torch

from vloam_tpu_torch.models import laser_mapping, lidar_odometry
from vloam_tpu_torch.models import frame_graph as fg
from vloam_tpu_torch.runtime.driver import VloamDriver

STRETCHES = 8


@dataclass
class Frame:
    run: int        # which replay of the drive (a fresh driver each)
    index: int      # frame index within the drive
    start: float    # host clock (time.perf_counter) when process() was called
    end: float      # ... when it returned


@dataclass
class Window:
    t0: float = 0.0
    t1: float = 0.0
    frames: list = field(default_factory=list)           # every process() call in the window
    drivers: dict = field(default_factory=dict)          # run -> VloamDriver
    errors: list = field(default_factory=list)
    trace: object = None                                  # vbench.trace.Trace or None
    trace_t: tuple = (0.0, 0.0)                           # host clock of the traced span
    knn_calls: list = field(default_factory=list)         # (host time, m/n/k per problem, counts)
    stretches: list = field(default_factory=list)         # Stretch of each eighth of the window

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def counted(self) -> list:
        """The frames whose process() returned inside the window."""
        return [f for f in self.frames if f.end <= self.t1]


@dataclass
class Stretch:
    wall_s: float
    frames: int = 0
    cpu_s: float = 0.0        # this process's user + system CPU seconds
    nivcsw: int = 0           # its involuntary context switches (preempted)
    host_busy: float = -1.0   # the host's busy share of all its CPUs, -1 where unread
    gc_s: float = 0.0         # seconds the garbage collector ran


def run_dir(out_dir: str, run: int) -> str:
    return os.path.join(out_dir, f"run{run:03d}")


def _host_jiffies():
    """(busy, total) jiffies of all the host's CPUs, or None off Linux."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None
    idle = v[3] + (v[4] if len(v) > 4 else 0)
    return sum(v) - idle, sum(v)


class StretchMeter:
    """Reads the process's and the host's counters at each stretch's
    boundary; the garbage collector's pauses through ``gc.callbacks``."""

    def __init__(self):
        self.gc_s, self._gc_t = 0.0, None
        self.out = []

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            self.gc_s += time.perf_counter() - self._gc_t
            self._gc_t = None

    @staticmethod
    def _counters():
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return ru.ru_utime + ru.ru_stime, ru.ru_nivcsw, _host_jiffies()

    def __enter__(self):
        gc.callbacks.append(self._gc)
        self._last = (time.perf_counter(), self.gc_s) + self._counters()
        return self

    def mark(self, frames: int) -> None:
        now, gc_s = time.perf_counter(), self.gc_s
        cpu, nivcsw, host = self._counters()
        t, g, c, n, h = self._last
        busy = -1.0
        if host is not None and h is not None and host[1] > h[1]:
            busy = (host[0] - h[0]) / (host[1] - h[1])
        self.out.append(Stretch(now - t, frames, cpu - c, nivcsw - n, busy, gc_s - g))
        self._last = (now, gc_s, cpu, nivcsw, host)

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)


class KnnRecorder:
    """Wraps ``knn_pair`` where LO and MO import it.  While ``on``, each
    call's shapes and its live query and candidate counts (device tensors,
    no sync) are kept for ``arith.knn_work``."""

    def __init__(self, window: Window):
        self.window, self.on = window, False

    @staticmethod
    def _live(q, c, mask, counts):
        q_count, c_count = counts
        n = c.shape[0]
        upto = n if c_count is None else c_count
        live_c = (mask & (torch.arange(n, device=c.device) < upto)).sum()
        live_q = q.shape[0] if q_count is None else q_count
        return torch.as_tensor(live_q, device=c.device).reshape(()), live_c

    def wrap(self, fn):
        def knn_pair(qa, ca, ma, ka, qb, cb, mb, kb, a_counts=(None, None),
                     b_counts=(None, None), **kw):
            out = fn(qa, ca, ma, ka, qb, cb, mb, kb, a_counts=a_counts, b_counts=b_counts, **kw)
            if self.on:
                rec = (time.perf_counter(),
                       ((qa.shape[0], ca.shape[0], ka), (qb.shape[0], cb.shape[0], kb)),
                       torch.stack([*self._live(qa, ca, ma, a_counts),
                                    *self._live(qb, cb, mb, b_counts)]))
                self.window.knn_calls.append(rec)
            return out
        return knn_pair

    @contextlib.contextmanager
    def installed(self):
        with contextlib.ExitStack() as stack:
            for mod in (lidar_odometry, laser_mapping):
                stack.enter_context(mock.patch.object(mod, "knn_pair", self.wrap(mod.knn_pair)))
            yield self


def replay(cfg, frames: list, seconds: float, out_dir: str, device, warmup: int,
           trace_seconds: float = 0.0, wrap_driver=None) -> Window:
    """Replay the drive ``frames`` (a list of (image, cloud)) for
    ``seconds``.  ``wrap_driver(driver)`` (tests) may replace a window
    driver's methods.  Returns the Window; its drivers are still open."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    ext = fg.kitti_default_extrinsics(dev)
    win = Window()

    def new_driver(run):
        drv = VloamDriver(cfg, ext, out_dir=run_dir(out_dir, run), device=dev)
        if wrap_driver is not None:
            wrap_driver(drv)
        win.drivers[run] = drv
        return drv

    warm = VloamDriver(cfg, ext, out_dir=None, device=dev)
    for img, cloud in frames[:warmup]:
        warm.process(img, cloud)
    del warm
    run, cursor = 0, 0
    drv = new_driver(run)
    rec = KnnRecorder(win)
    prof = None
    if trace_seconds > 0:
        # started (and CUPTI brought up: seconds) in set-up, recording from its second step
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1))
        prof.start()
    if cuda:
        torch.cuda.synchronize(dev)
    with rec.installed(), StretchMeter() as meter:
        win.t0 = time.perf_counter()
        win.t1 = win.t0 + seconds
        edge, done = win.t0 + seconds / STRETCHES, 0
        try:
            while True:
                now = time.perf_counter()
                while now >= edge and len(meter.out) < STRETCHES:
                    meter.mark(len(win.frames) - done)
                    done, edge = len(win.frames), edge + seconds / STRETCHES
                if now >= win.t1:
                    break
                if prof is not None and not rec.on and now >= win.t1 - trace_seconds:
                    prof.step()
                    rec.on = True
                    win.trace_t = (time.perf_counter(), 0.0)
                if cursor == len(frames):
                    drv.close()
                    run, cursor = run + 1, 0
                    drv = new_driver(run)
                img, cloud = frames[cursor]
                a = time.perf_counter()
                drv.process(img, cloud)
                win.frames.append(Frame(run, cursor, a, time.perf_counter()))
                cursor += 1
        except Exception as e:   # reported as the run's failure, after the window
            win.errors.append(f"{type(e).__name__}: {e}")
        win.stretches = meter.out
        if cuda:
            torch.cuda.synchronize(dev)
        if prof is not None and rec.on:
            win.trace_t = (win.trace_t[0], time.perf_counter())
            rec.on = False
            prof.stop()
            from vbench.trace import Trace
            win.trace = Trace.from_profiler(prof)
        elif prof is not None:   # the window ended before the traced span began
            prof.stop()
    return win
