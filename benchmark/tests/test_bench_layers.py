"""The frame step's layer metrics (``visual_odometry_ms``,
``scan_registration_ms``, ``laser_odometry_ms``, ``laser_mapping_ms``,
``device_wait_ms``, ``idle_in_dispatch_pct``): each reader on a canned run
against a known answer, and on a program without the spans, where it reads
nothing.  On a card: every span of the driver's timeline lies within 100 us
of its ``record_function`` twin in a profiler trace, and each frame's
``wait.<site>`` spans are the synchronising calls ``SyncCounter`` counts."""

import collections
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT, run_small, small_cell
from vbench import spec
from vbench.main import Run
from vbench.trace import Trace

MS = 1_000_000   # ns
LAYER_METRICS = ("visual_odometry_ms", "scan_registration_ms", "laser_odometry_ms",
                 "laser_mapping_ms", "device_wait_ms")
STAGES = {"vloam_step": (1000.0, 10), "visual_odometry": (300.0, 10),
          "scan_registration": (50.0, 10), "laser_odometry": (100.0, 10),
          "laser_mapping": (400.0, 10), "wait.fetch": (20.0, 10), "wait.map_ready": (30.0, 10),
          "wait.slot_dims": (5.0, 11), "host_grid": (700.0, 10)}


def canned_run(stages=STAGES, timelines=True):
    """Ten frames' stage totals, and 100 ms of trace: the card busy over
    10-20 and 50-60 ms; one driver in VO over 5-30, in MO over 40-80 with a
    wait over 45-55, in the fetch over 90-95; a second driver in scan
    registration over 85-88."""
    def timer(spans):
        spans = [(name, s * MS, e * MS) for name, s, e in spans]
        return SimpleNamespace(timeline=collections.deque(spans)) if timelines \
            else SimpleNamespace()
    drivers = {0: SimpleNamespace(timer=timer([
                   ("visual_odometry", 5, 30), ("wait.map_ready", 45, 55),
                   ("laser_mapping", 40, 80), ("wait.fetch", 90, 95), ("vloam_step", 5, 95)])),
               1: SimpleNamespace(timer=timer([("scan_registration", 85, 88)]))}
    trace = Trace(device_ops=[("k", 10 * MS, 20 * MS), ("k", 50 * MS, 60 * MS)],
                  span_ns=(0, 100 * MS))
    return Run(None, SimpleNamespace(trace=trace, drivers=drivers), dict(stages), [], [])


@pytest.mark.parametrize("name,want", [("visual_odometry_ms", 30.0),
                                       ("scan_registration_ms", 5.0),
                                       ("laser_odometry_ms", 10.0), ("laser_mapping_ms", 40.0),
                                       ("device_wait_ms", 5.5),
                                       # idle 80 ms; in the layers and out of the waits:
                                       # 5 + 10 + 5 + 20 + 3 = 43 ms
                                       ("idle_in_dispatch_pct", 100.0 * 43 / 80)])
def test_reader_on_a_canned_run(name, want):
    assert spec.metric_reader(name)(canned_run()) == pytest.approx(want)


@pytest.mark.parametrize("name", LAYER_METRICS + ("idle_in_dispatch_pct",))
def test_reader_without_the_spans_reads_nothing(name):
    """The program before the spans: its stages only, no timeline."""
    old = {k: v for k, v in STAGES.items() if k in ("vloam_step", "host_grid")}
    assert spec.metric_reader(name)(canned_run(old, timelines=False)) is None
    run = canned_run()
    run.window.trace = None
    assert name != "idle_in_dispatch_pct" or spec.metric_reader(name)(run) is None


def test_traced_run_reads_the_spans():
    """A traced run on the CPU reads every span metric, and the four layers
    with the fetch lie inside the step; the CPU has no device trace."""
    drivers = []
    res = run_small(small_cell(frames=4, judged=2), seconds=3.0, trace=True,
                    wrap_driver=drivers.append)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(LAYER_METRICS) | {"step_ms", "host_stages_ms"} <= set(m)
    assert "idle_in_dispatch_pct" not in m
    assert all(m[k] > 0 for k in LAYER_METRICS)
    ms = collections.Counter()
    for d in drivers:
        ms.update(d.timer.total_ms)
    layers = sum(ms[k[:-3]] for k in LAYER_METRICS[:4])
    assert layers + ms["wait.fetch"] <= ms["vloam_step"]
    frames = sum(d.timer.count["vloam_step"] for d in drivers)
    assert m["laser_mapping_ms"] == pytest.approx(ms["laser_mapping"] / frames)


def card_frames(card, n):
    """The first ``n`` frames of ``klt.street1``'s drive at its own sizes."""
    from vloam_tpu_torch import config as port_config
    from vloam_tpu_torch.models import frame_graph as fg
    from vbench import traffic
    cell = spec.load_cell(ROOT, "klt.street1")
    cfg = spec.build_config(port_config, cell.config["vloam"])
    K = fg.kitti_default_extrinsics("cpu").P_rect0[:, :3].numpy().astype(np.float64)
    frames, _ = traffic.make_drive(cell.traffic, cfg.visual.img_height, cfg.visual.img_width,
                                   K, 2**31 + 2101, 0, card, n_frames=n)
    return cfg, frames


@pytest.mark.card
def test_spans_on_the_card(card):
    from vbench.syncs import SyncCounter
    from vbench.trace import _kind
    from vloam_tpu_torch.models import frame_graph as fg
    from vloam_tpu_torch.runtime.driver import VloamDriver

    cfg, frames = card_frames(card, 40)
    drv = VloamDriver(cfg, fg.kitti_default_extrinsics(card), device=card)
    for f in frames[:12]:
        drv.process(*f)
    P = torch.profiler
    prof = P.profile(activities=[P.ProfilerActivity.CPU, P.ProfilerActivity.CUDA],
                     schedule=P.schedule(wait=0, warmup=1, active=1))
    prof.start()
    drv.process(*frames[12])
    prof.step()
    n0 = len(drv.timer.timeline)
    for f in frames[13:23]:
        drv.process(*f)
    torch.cuda.synchronize(card)
    prof.stop()
    twins = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if _kind(ev) == "user_annotation":
            twins[ev.name()].append((ev.start_ns(), ev.end_ns()))
    spans = list(drv.timer.timeline)[n0:]
    seen, d_start, d_end = collections.Counter(), [], []
    for name, s, e in spans:
        ts, te = sorted(twins[name])[seen[name]]
        seen[name] += 1
        d_start.append(s - ts)
        d_end.append(e - te)
    print(f"spans: {len(spans)} in 10 frames, {dict(seen)}; ns from the twin: start median "
          f"{np.median(d_start):.0f}, {min(d_start)} to {max(d_start)}; end median "
          f"{np.median(d_end):.0f}, {min(d_end)} to {max(d_end)}")
    assert len(spans) >= 10 * 10
    assert max(map(abs, d_start + d_end)) < 100_000

    # each frame's waits, in order, are the synchronising calls in order
    site_of = {}
    for i, f in enumerate(frames[23:40], 23):
        n0 = len(drv.timer.timeline)
        with SyncCounter() as sc:
            drv.process(*f)
        waits = [name for name, _, _ in list(drv.timer.timeline)[n0:] if name.startswith("wait.")]
        print(f"frame {i}: {sc.count} syncs at {sc.sites}; waits {waits}")
        assert len(waits) == sc.count, (waits, sc.sites)
        for name, site in zip(waits, sc.sites):
            assert site_of.setdefault(name, site) == site, (name, site, site_of)
    assert len(set(site_of.values())) == len(site_of)
    assert site_of["wait.fetch"].startswith("driver.py:")
    assert all(site.startswith("laser_mapping.py:") for name, site in site_of.items()
               if name != "wait.fetch")
    print(f"wait sites: {site_of}")
