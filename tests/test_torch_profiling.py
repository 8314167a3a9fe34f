"""``utils/profiling``: ``span`` records into the innermost ``StageTimer``
stage open on its thread, the timer's timeline is bounded, and its stamps
lie on the clock of the profiler's ``record_function`` events."""

import threading

import pytest
import torch

from vloam_tpu_torch.utils import profiling
from vloam_tpu_torch.utils.profiling import StageTimer, span


def profiled(fn):
    """Run ``fn`` in the active step of a CPU profiler that, as the
    benchmark's does, first records a warm-up step; returns its ranges as
    {name: [(start_ns, end_ns), ...]}."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  schedule=torch.profiler.schedule(wait=0, warmup=1, active=1))
    prof.start()
    with torch.profiler.record_function("warm-up"):
        pass
    prof.step()
    fn()
    prof.stop()
    out = {}
    for ev in prof.profiler.kineto_results.events():
        out.setdefault(ev.name(), []).append((ev.start_ns(), ev.end_ns()))
    return {name: sorted(r) for name, r in out.items()}


def test_span_inside_stage_lands_in_its_timer():
    timer = StageTimer()
    with timer.stage("vloam_step"):
        with span("laser_mapping"):
            pass
    assert timer.count["laser_mapping"] == 1 and timer.total_ms["laser_mapping"] >= 0.0
    assert timer.parent == {"vloam_step": None, "laser_mapping": "vloam_step"}
    assert [name for name, _, _ in timer.timeline] == ["laser_mapping", "vloam_step"]
    (_, s_in, e_in), (_, s_out, e_out) = timer.timeline
    assert s_out <= s_in <= e_in <= e_out


def test_span_on_another_thread_is_not_counted():
    timer = StageTimer()

    def other():
        with span("wait.fetch"):
            pass
    with timer.stage("vloam_step"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert set(timer.count) == {"vloam_step"} and len(timer.timeline) == 1


def test_span_without_a_stage_only_opens_the_range():
    timer = StageTimer()
    with pytest.raises(RuntimeError):
        with timer.stage("host_grid"):
            raise RuntimeError("a failed stage closes")

    def run():
        with span("visual_odometry"):
            pass
    ranges = profiled(run)
    assert len(ranges["visual_odometry"]) == 1
    assert not timer.count and not timer.timeline


def test_nested_totals_and_summary():
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("vloam_step"):
            with span("laser_mapping"):
                with span("wait.map_ready"):
                    torch.ones(64).sum()
            with span("wait.fetch"):
                pass
        with timer.stage("host_f64_chain"):
            pass
    t = timer.total_ms
    assert t["vloam_step"] >= t["laser_mapping"] + t["wait.fetch"]
    assert t["laser_mapping"] >= t["wait.map_ready"] > 0.0
    assert all(timer.count[n] == 2 for n in t)
    lines = timer.summary().splitlines()
    assert [ln.split()[0] for ln in lines] == ["vloam_step", "laser_mapping", "wait.map_ready",
                                               "wait.fetch", "host_f64_chain"]
    assert [len(ln) - len(ln.lstrip()) for ln in lines] == [0, 2, 4, 2, 0]
    assert all(ln.endswith("n=2") for ln in lines)


def test_timeline_is_bounded(monkeypatch):
    assert StageTimer().timeline.maxlen >= 50 * 20 * 15   # 50 s at 20 frames/s, 15 spans each
    monkeypatch.setattr(profiling, "TIMELINE_LEN", 4)
    timer = StageTimer()
    for i in range(10):
        with timer.stage(f"s{i}"):
            pass
    assert [name for name, _, _ in timer.timeline] == ["s6", "s7", "s8", "s9"]
    assert timer.count["s0"] == 1   # the totals keep what the timeline drops


def test_timeline_on_the_profilers_clock():
    timer = StageTimer()

    def run():
        for _ in range(10):
            with timer.stage("vloam_step"):
                with span("visual_odometry"):
                    torch.ones(256).cumsum(0)
                with span("wait.fetch"):
                    pass
    ranges = profiled(run)
    seen = {}
    for name, s, e in timer.timeline:
        twin_s, twin_e = ranges[name][seen.setdefault(name, 0)]
        seen[name] += 1
        assert abs(s - twin_s) < 100_000 and abs(e - twin_e) < 100_000, (name, s - twin_s,
                                                                         e - twin_e)
    assert seen == {"vloam_step": 10, "visual_odometry": 10, "wait.fetch": 10}


class _FakeEvent:
    """A CUDA timing event on a fake clock: ``record`` stamps the clock,
    ``query`` says whether the fake card has passed the stamp."""
    clock, done = 0.0, 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        self.t = _FakeEvent.clock

    def query(self):
        return self.t is not None and self.t <= _FakeEvent.done

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return end.t - self.t


def test_device_span_is_read_once_the_card_has_passed_it(monkeypatch):
    """On a card, ``device_span`` leaves two events pending and is read, with
    no synchronisation, when a later stage or span of its timer closes
    after the card has passed its end: into ``dev.<name>``, under the stage
    or span it ran in, and not on the timeline.  Inside a capture it
    records nothing."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(_FakeEvent, "clock", 0.0)
    monkeypatch.setattr(_FakeEvent, "done", -1.0)
    timer = StageTimer()
    with timer.stage("vloam_step"):
        with span("visual_odometry"), profiling.device_span("visual_odometry", "cuda:0"):
            _FakeEvent.clock = 2.5          # the card's work the block queued
        assert len(timer.pending) == 1      # not passed yet: kept pending
        with span("laser_mapping"):
            pass
        assert timer.count["dev.visual_odometry"] == 0
        _FakeEvent.done = 2.5               # the fetch waited for the frame
        with span("wait.fetch"):
            pass
        assert timer.count["dev.visual_odometry"] == 1 and not timer.pending
        capturing[0] = True
        with profiling.device_span("visual_odometry", "cuda:0"):
            pass
        assert not timer.pending
    assert timer.total_ms["dev.visual_odometry"] == 2.5
    assert timer.parent["dev.visual_odometry"] == "visual_odometry"
    assert "dev.visual_odometry" not in {name for name, _, _ in timer.timeline}
    assert "dev.visual_odometry" in timer.summary()
