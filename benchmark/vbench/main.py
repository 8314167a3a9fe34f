"""One run of one cell: set-up, the measured window, the per-layer reading
(with ``--trace 1``), the comparison with the plain reference, and the
result line.

Set-up is everything from the process's start to the window's opening:
imports, the kernel library and the host library (built once into the
checkout's ``vloam_tpu_torch/_build/``, then found there), the drive made
on the card and copied to host memory, and the warm-up.  The
reference runs after the window has closed, the peak memory has been read
and the program's state has been freed; it is not set-up.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "vloam_tpu")


@dataclass
class Run:
    """What a per-layer metric's reader reads."""
    cell: object           # spec.Cell
    window: object         # replay.Window
    stages: dict           # stage -> (summed ms, calls) over the window drivers
    syncs: list            # synchronising calls of each frame counted after the window
    knn: list              # per k-NN pair call, its two problems' (m, n, k, live_q, live_c)


def log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def stage_totals(win) -> dict:
    tot = {}
    for drv in win.drivers.values():
        for name, ms in drv.timer.total_ms.items():
            s, n = tot.get(name, (0.0, 0))
            tot[name] = (s + ms, n + drv.timer.count[name])
    return tot


def count_syncs(win, frames, n_frames: int) -> list:
    """Synchronising calls of each of ``n_frames`` frames fed, after the
    window, to the last window driver (its next frames: none is fed twice)."""
    import torch
    from vbench.syncs import SyncCounter

    run = max(win.drivers)
    done = sum(1 for f in win.frames if f.run == run)
    out = []
    for img, cloud in frames[done:done + n_frames]:
        with SyncCounter() as sc:
            win.drivers[run].process(img, cloud)
        out.append(sc.count)
    torch.cuda.synchronize()
    return out


def log_stretches(win) -> None:
    """Where the window's time went, an eighth at a time (replay.Stretch)."""
    for k, s in enumerate(win.stretches):
        host = f"{100 * s.host_busy:.1f} %" if s.host_busy >= 0 else "unread"
        log(f"stretch {k}: {s.frames / s.wall_s:.2f} frames/s, process CPU "
            f"{100 * s.cpu_s / s.wall_s:.1f} %, {s.nivcsw} preemptions, host busy {host}, "
            f"gc {1e3 * s.gc_s:.1f} ms")


def cam_T_base() -> np.ndarray:
    """The rows' camera from the base (the lidar): the inverse of the
    plain reference's nominal KITTI ``base_T_cam0``."""
    from plainref import geometry_np as gnp
    from plainref.models import frame_graph as ref_fg
    b = ref_fg.kitti_default_extrinsics("cpu").base_T_cam0.numpy()
    return np.linalg.inv(gnp.pose_to_matrix(gnp.as_pose64(b)))


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        wrap_driver=None) -> dict:
    """Run ``cell`` once on ``device``; returns the result line's object
    (its ``checks`` key last).  ``wrap_driver`` and a CPU ``device`` serve
    the tests."""
    import torch

    import vloam_tpu_torch.config as port_config
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.models import frame_graph as fg
    from vloam_tpu_torch.runtime import native
    from vbench import judge, spec, traffic
    from vbench.replay import replay, run_dir

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.set_num_threads(1)   # the window's host work is one thread (run.py)
    tr = cell.traffic
    if cuda:
        kernels.lib()            # builds the library into the checkout once
    native.available()           # builds the host library once (False: the NumPy host path)
    cfg = spec.build_config(port_config, cell.config["vloam"])
    vc = cfg.visual
    ext = fg.kitti_default_extrinsics("cpu")
    K = ext.P_rect0[:, :3].numpy().astype(np.float64)
    t_gen = time.perf_counter()
    frames, (R, t) = traffic.make_drive(tr, vc.img_height, vc.img_width, K, seed, 0, dev)
    log(f"drive made in {time.perf_counter() - t_gen:.3f} s; set-up so far "
        f"{time.perf_counter() - t_start:.3f} s")
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    tmp = tempfile.mkdtemp(prefix="vbench-")
    try:
        rows_dir = os.path.join(tmp, "rows")
        win = replay(cfg, frames, seconds, rows_dir, dev, tr["warmup_frames"],
                     trace_seconds=tr["trace_seconds"] if trace else 0.0,
                     wrap_driver=wrap_driver)
        setup_s = win.t0 - t_start
        log_stretches(win)
        log(f"window: {len(win.frames)} frames in {win.seconds:.3f} s; set-up {setup_s:.3f} s"
            + (f"; traced {win.trace_t[1] - win.trace_t[0]:.3f} s" if win.trace else ""))
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        stages = stage_totals(win)
        syncs = count_syncs(win, frames, tr["sync_frames"]) if trace and cuda else []
        knn = []
        for _, shapes, live in win.knn_calls:
            c = live.tolist()
            knn.append(tuple(shape + (c[2 * j], c[2 * j + 1]) for j, shape in enumerate(shapes)))
        for drv in win.drivers.values():
            drv.close()
        detach = int(cfg.detach_vo_lo)
        rows = {key: judge.read_rows(run_dir(rows_dir, key), detach) for key in win.drivers}
        fed = {key: sum(1 for f in win.frames if f.run == key) for key in rows}
        if syncs:
            fed[max(fed)] += len(syncs)
        problems = judge.exports(rows, fed)
        numbers = judge.drift(rows, judge.truth_rows(R, t, cam_T_base()), tr["drift_from_m"])
        counted = win.counted()
        attempted = len(win.frames)
        errors = list(win.errors)
        failed = len(errors)
        r = Run(cell, win, stages, syncs, knn)
        prof_trace = win.trace
        per_layer = {}
        if trace:
            for m in cell.per_layer:
                value = spec.metric_reader(m["name"])(r)
                if value is not None:
                    per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
        # free the program's state before the reference runs
        del r, win, stages
        gc.collect()
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
        judged = tr["judged_frames"]
        import plainref.config as ref_config
        ref_cfg = spec.build_config(ref_config, cell.config["vloam"])
        t_ref = time.perf_counter()
        reference = judge.reference_rows(ref_cfg, frames, judged, dev)
        log(f"reference: {judged} frames in {time.perf_counter() - t_ref:.3f} s")
        program = rows.get(0, {c: np.zeros((0, 3, 4)) for c in judge.CHAINS})
        gap_numbers, gap_problems = judge.gaps(program, reference, judged)
        numbers.update(gap_numbers)
        for c, g in judge.frame_gaps(program, reference, judged).items():
            log(f"{c} gap a frame (m): " + " ".join(f"{x:.3g}" for x in g))
        log("numbers: " + " ".join(f"{k} {v!r}" for k, v in sorted(numbers.items())))
        problems += gap_problems
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    problems = [f"the window failed: {e}" for e in errors] + problems
    correct, checks = judge.verdict(numbers, cell.limits, problems)
    if trace:
        metrics = per_layer
    else:
        metrics = {"frames_per_s": {"value": len(counted) / seconds, "unit": "frames/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and prof_trace is not None:
        t = prof_trace
        device_info["busy_s"], device_info["window_s"] = t.busy_s(), t.window_s()
        result["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
    result["problems"] = problems
    result["checks"] = checks
    return result


def main(argv, t_start: float, root: str) -> int:
    args = parse(argv)
    from vbench import spec
    cell = spec.load_cell(root, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    for p in result["problems"]:
        print(f"problem: {p}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
