#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its lidar slice on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. the card (name and power limit from nvidia-smi), torch/CUDA versions,
   nvcc, and whether triton imports;
2. the kernel build from ``vloam_tpu_torch/csrc`` and its seconds;
3. each kernel against its plain PyTorch version on the card, on the
   arguments the slice passes at its four k-NN and two GN call shapes
   (taken from a short warm-up drive), with the tolerances below, and the
   median times of both (CUDA events, 20 runs);
4. the slice (scan registration -> LO -> MO) at full ``kitti_hdl64`` width
   with the whole map on the device: 40 synthetic HDL-64 scans of ~100k
   points along a gently turning street (crossing the x = 25 m cube
   boundary near frame 32), checked against ground truth and against the
   kernels' launch counts.

Then one JSON line of per-kernel results, the card's name and power limit,
and last the line ``{"ok": true, "device": {...}}``.  Any failure raises
and exits nonzero before that line; so does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

N_FRAMES = 40
N_WARMUP = 16          # frames of the warm-up drive whose state feeds phase 3
SPEED, YAW_RATE = 0.8, 0.005
N_AZIMUTH, NOISE = 1800, 0.005
TIMING_RUNS = 20

KNN_D2_TOL = 1e-4      # m^2, kernel vs plain
KNN_IDX_AGREE = 0.999  # disagreement allowed only at d2 ties
GN_T_TOL = 1e-3        # m
GN_QDOT_TOL = 1e-6     # |q . q'| >= 1 - tol
LO_STEP_TOL = 0.05     # m per axis, f2f translation vs ground truth
DRIFT_TOL = 0.03       # final position error / path length


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def gen_frames(cfg, n_frames):
    """Host data (not timed): raycast scans, ring grids, less-flat tables."""
    from vloam_tpu_torch.data import synthetic
    from vloam_tpu_torch.data.gridding import grid_cloud, less_flat_voxel_table

    boxes = synthetic.default_scene()
    box_cx = (boxes[:, 0] + boxes[:, 3]) / 2.0
    poses = synthetic.straight_trajectory(n_frames, speed=SPEED, yaw_rate=YAW_RATE)
    frames, n_pts = [], []
    for i, (R, t) in enumerate(poses):
        # rays reach 80 m: boxes whose centre is > 100 m away cannot be hit
        near = boxes[np.abs(box_cx - t[0]) < 100.0]
        cloud = synthetic.simulate_scan(R, t, near, n_azimuth=N_AZIMUTH, noise=NOISE, seed=i)
        grid, gmask, _ = grid_cloud(cloud, cfg.scan)
        frames.append((grid, gmask, less_flat_voxel_table(grid, gmask, cfg.scan)))
        n_pts.append(len(cloud))
    return frames, poses, n_pts


def time_ms(fn, runs=TIMING_RUNS) -> float:
    """Median milliseconds of fn() over ``runs`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def knn_compare(name, got, ref):
    """Kernel (d2, idx) vs plain (d2, idx): same +inf pattern, d2 within
    KNN_D2_TOL, indices equal except at d2 ties."""
    (d2k, ik), (d2p, ip) = got, ref
    assert torch.equal(torch.isinf(d2k), torch.isinf(d2p)), f"{name}: +inf pattern differs"
    fin = torch.isfinite(d2p)
    err = float((d2k[fin] - d2p[fin]).abs().max()) if bool(fin.any()) else 0.0
    assert err <= KNN_D2_TOL, f"{name}: d2 max abs diff {err}"
    same = ik == ip
    agree = float(same.float().mean())
    tie = (d2k - d2p).abs() <= KNN_D2_TOL
    assert bool(torch.all(same | tie)), f"{name}: index disagreement away from a d2 tie"
    assert agree >= KNN_IDX_AGREE, f"{name}: index agreement {agree}"
    print(f"  {name}: d2 max abs diff {err:.3e} m^2, idx agreement {agree:.6f}, "
          f"finite {int(fin.sum())}/{fin.numel()}")
    return err


def gn_compare(name, got, ref):
    q = torch.sign(torch.dot(got[:4], ref[:4]))
    dt = float((got[4:] - ref[4:]).abs().max())
    qdot = float(torch.dot(got[:4], ref[:4]).abs())
    assert bool(torch.isfinite(got).all()), f"{name}: non-finite pose {got}"
    assert dt <= GN_T_TOL, f"{name}: translation diff {dt}"
    assert qdot >= 1.0 - GN_QDOT_TOL, f"{name}: |q.q'| = {qdot}"
    err = float(torch.cat([got[:4] * q - ref[:4], got[4:] - ref[4:]]).abs().max())
    print(f"  {name}: translation diff {dt:.3e} m, |q.q'| {qdot:.9f}")
    return err


def capture_call_args(state, frame, cfg):
    """Run one slice frame and record the arguments that LO and MO pass to
    knn_pair and solve_pose_gn_lidar in their first outer iteration:
    {(kernel, site): (args, kwargs)}."""
    from vloam_tpu_torch.models import laser_mapping, lidar_odometry
    from vloam_tpu_torch.models.lidar_slice import lidar_step
    from vloam_tpu_torch.ops import fused_gn, fused_knn

    calls = {}

    def recorder(key, fn):
        def record(*args, **kw):
            calls.setdefault(key, (args, kw))
            return fn(*args, **kw)
        return record

    with contextlib.ExitStack() as stack:
        for site, mod in (("LO", lidar_odometry), ("MO", laser_mapping)):
            stack.enter_context(mock.patch.object(
                mod, "knn_pair", recorder(("knn", site), fused_knn.knn_pair)))
            stack.enter_context(mock.patch.object(
                mod, "solve_pose_gn_lidar", recorder(("gn", site), fused_gn.solve_pose_gn_lidar)))
        lidar_step(state, *frame, cfg)
    return calls


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1

    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.config import kitti_hdl64

    dev = torch.device("cuda", 0)
    card = card_line()

    # ---- phase 1: the card ---------------------------------------------------
    print("== phase 1: card")
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[0]} | {nvcc[-2] if len(nvcc) > 1 else ''}")
    try:
        import triton  # noqa: F401
        print(f"triton: importable ({triton.__version__})")
    except ImportError as e:
        print(f"triton: not importable ({e})")

    # ---- phase 2: kernel build -------------------------------------------------
    print("== phase 2: kernel build")
    t0 = time.perf_counter()
    so = kernels.build(verbose=True)
    kernels.lib()
    print(f"built {so.name} from {', '.join(kernels.SOURCES)} in {time.perf_counter() - t0:.2f} s")

    kern = check_slice(kitti_hdl64(), dev, card, N_FRAMES, N_WARMUP)
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def check_slice(cfg, dev, card, n_frames, n_warmup):
    """Phases 3 and 4; returns the per-kernel result records."""
    from vloam_tpu_torch.models.lidar_slice import frame_to_device, init_lidar_state, lidar_step
    from vloam_tpu_torch.ops import fused_gn, fused_knn

    t0 = time.perf_counter()
    frames, poses, n_pts = gen_frames(cfg, n_frames)
    print(f"host data: {n_frames} scans, {int(np.mean(n_pts))} points/scan on average, "
          f"{time.perf_counter() - t0:.1f} s (not timed below)")
    dframes = [frame_to_device(g, m, lf, dev) for g, m, lf in frames]

    # ---- phase 3: kernels vs plain versions ------------------------------------
    print(f"== phase 3: kernels vs plain PyTorch versions, at the slice's call shapes "
          f"(state after a {n_warmup}-frame warm-up drive) [{card}]")
    state = init_lidar_state(cfg, dev)
    for f in dframes[:n_warmup]:
        state, _ = lidar_step(state, *f, cfg)
    calls = capture_call_args(state, dframes[n_warmup], cfg)
    del state
    results = {"knn_pair": {"err": 0.0, "ms": 0.0, "plain_ms": 0.0},
               "gn_lidar": {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}}
    for site in ("LO", "MO"):
        args, kw = calls[("knn", site)]
        qa, ca, _, ka, qb, cb, _, kb = args
        got = fused_knn.knn_pair(*args, **kw)
        ref = fused_knn.knn_pair_reference(*args, **kw)
        torch.cuda.synchronize()
        r = results["knn_pair"]
        for g_, r_, q, c, k in ((got[0], ref[0], qa, ca, ka), (got[1], ref[1], qb, cb, kb)):
            shape = f"{site} {q.shape[0]}x{c.shape[0]} k={k}"
            r["err"] = max(r["err"], knn_compare(f"knn {shape}", g_, r_))
        ms = time_ms(lambda: fused_knn.knn_pair(*args, **kw))
        plain = time_ms(lambda: fused_knn.knn_pair_reference(*args, **kw))
        r["ms"] += ms
        r["plain_ms"] += plain
        print(f"  knn_pair {site} pair: kernel {ms:.4f} ms, plain {plain:.4f} ms "
              f"(median of {TIMING_RUNS}) [{card}]")
    for site in ("LO", "MO"):
        args, _ = calls[("gn", site)]
        got = fused_gn.solve_pose_gn_lidar(*args)
        ref = fused_gn.solve_pose_gn_lidar_reference(*args)
        torch.cuda.synchronize()
        r = results["gn_lidar"]
        shape = f"{site} Be={args[1][0].shape[0]} Bs={args[2][0].shape[0]}"
        r["err"] = max(r["err"], gn_compare(f"gn {shape}", got, ref))
        ms = time_ms(lambda: fused_gn.solve_pose_gn_lidar(*args))
        plain = time_ms(lambda: fused_gn.solve_pose_gn_lidar_reference(*args))
        r["ms"] += ms
        r["plain_ms"] += plain
        print(f"  gn_lidar {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms "
              f"(median of {TIMING_RUNS}) [{card}]")
    del calls

    # ---- phase 4: the slice at full width ---------------------------------------
    print(f"== phase 4: lidar slice, kitti_hdl64, {n_frames} frames [{card}]")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_lidar_state(cfg, dev)
    print(f"  map on device: cube array {tuple(state.mp.cube_pts.shape)} "
          f"({state.mp.cube_pts.numel() * 4 / 2**20:.0f} MiB)")
    fused_knn.LAUNCHES = 0
    fused_gn.LAUNCHES = 0
    outs, frame_ms, per_frame = [], [], []
    for i, f in enumerate(dframes):
        k0, g0 = fused_knn.LAUNCHES, fused_gn.LAUNCHES
        t0 = time.perf_counter()
        state, out = lidar_step(state, *f, cfg)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        per_frame.append((fused_knn.LAUNCHES - k0, fused_gn.LAUNCHES - g0))
        outs.append(out)
    launches = {"knn_pair": fused_knn.LAUNCHES, "gn_lidar": fused_gn.LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev)

    for i, (nk, ng) in enumerate(per_frame[1:], start=1):
        assert (nk, ng) == (4, 4), f"frame {i}: {nk} knn_pair and {ng} gn_lidar launches, want 4 and 4"
    assert launches["knn_pair"] > 0 and launches["gn_lidar"] > 0
    worst_step = 0.0
    for i, out in enumerate(outs):
        for name in ("world_lo", "world_mo", "lo_delta"):
            v = getattr(out, name)
            assert bool(torch.isfinite(v).all()), f"frame {i}: non-finite {name} {v}"
        if i >= 1:
            (R0, t0_), (_, t1_) = poses[i - 1], poses[i]
            gt = R0.T @ (t1_ - t0_)
            step_err = np.abs(outs[i].lo_delta[4:].cpu().numpy() - gt).max()
            worst_step = max(worst_step, float(step_err))
            assert step_err < LO_STEP_TOL, f"frame {i}: LO f2f translation off by {step_err} m"
    gt_end = poses[-1][1]
    path = SPEED * (n_frames - 1)
    lo_err = float(np.linalg.norm(outs[-1].world_lo[4:].cpu().numpy() - gt_end))
    mo_err = float(np.linalg.norm(outs[-1].world_mo[4:].cpu().numpy() - gt_end))
    assert lo_err / path <= DRIFT_TOL, f"LO drift {lo_err} m over {path} m"
    assert mo_err / path <= DRIFT_TOL, f"MO drift {mo_err} m over {path} m"
    mp = state.mp
    print(f"  launches per frame from frame 1: knn_pair {per_frame[1][0]}, gn_lidar {per_frame[1][1]}; "
          f"totals {launches}")
    print(f"  LO f2f translation: worst axis error {worst_step * 100:.2f} cm (bound "
          f"{LO_STEP_TOL * 100:.0f} cm); final error LO {lo_err:.3f} m "
          f"({lo_err / path * 100:.2f} %), MO {mo_err:.3f} m ({mo_err / path * 100:.2f} %) "
          f"over {path:.1f} m")
    print(f"  map: {int(mp.corner_cnt.sum())} corner + {int(mp.surf_cnt.sum())} surf points; "
          f"submap cache {int(mp.sub_c_n)} + {int(mp.sub_s_n)}")
    steady = frame_ms[5:]
    print(f"  ms/frame (host clock, synchronised, frames 5..{n_frames - 1}): median "
          f"{statistics.median(steady):.3f}, min {min(steady):.3f}, max {max(steady):.3f}; "
          f"frame 0 {frame_ms[0]:.3f}; peak device memory {peak / 2**20:.1f} MiB [{card}]")

    return [
        {"name": "knn_pair", "route": "cuda", "source": "vloam_tpu_torch/csrc/knn_pair.cu",
         "replaces": "vloam_tpu/ops/pallas_knn.py:124", "launches": launches["knn_pair"],
         "max_abs_err": results["knn_pair"]["err"], "ms": results["knn_pair"]["ms"],
         "plain_ms": results["knn_pair"]["plain_ms"]},
        {"name": "gn_lidar", "route": "cuda", "source": "vloam_tpu_torch/csrc/gn_lidar.cu",
         "replaces": "vloam_tpu/ops/pallas_gn.py:138", "launches": launches["gn_lidar"],
         "max_abs_err": results["gn_lidar"]["err"], "ms": results["gn_lidar"]["ms"],
         "plain_ms": results["gn_lidar"]["plain_ms"]},
    ]


if __name__ == "__main__":
    sys.exit(main())
