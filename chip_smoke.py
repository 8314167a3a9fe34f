#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its frame step on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. the card (name and power limit from nvidia-smi), torch/CUDA versions,
   nvcc, and whether triton imports;
2. the kernel build from ``vloam_tpu_torch/csrc`` (one nvcc per source, all
   at once) and its seconds;
3. each kernel against its plain PyTorch version on the card, on the
   arguments the frame step passes it (captured from a warm-up drive of the
   full step): the k-NN pair and lidar GN at LO's and MO's call shapes, the
   VO GN solve on a tracked frame, and the KLT patch gather at the two
   coarse pyramid levels of frame 1 and at level 0 of a tracked frame; with
   the tolerances below and the median times of both (CUDA events, 20 runs);
4. the lidar slice (scan registration -> LO -> MO) alone, 12 frames;
5. the full step ``vloam_step`` in the decoupled (D) mode at full
   ``kitti_hdl64`` width with the whole map on the device: 40 frames of
   the ``bench._gen_frames`` course (synthetic HDL-64 scans of ~100k points
   and 376x1248 blob images along a gently turning street, crossing the
   x = 25 m cube boundary near frame 32), checked against ground truth, the
   kernels' launch counts and the slice's count of synchronising calls;
6. the coupled (C) mode, 12 frames of the same course.

Then one JSON line of per-kernel results, the card's name and power limit,
and last the line ``{"ok": true, "device": {...}}``.  Any failure raises
and exits nonzero before that line; so does a machine without CUDA.
"""

from __future__ import annotations

import collections
import contextlib
import json
import statistics
import subprocess
import sys
import time
import warnings
from unittest import mock

import numpy as np
import torch

N_FRAMES = 40          # full step (D), phase 5
N_SHORT = 12           # lidar slice (phase 4) and coupled mode (phase 6)
N_WARMUP = 16          # frames of the warm-up drive whose calls feed phase 3
SYNC_FRAME = 11        # the steady frame whose synchronising calls are counted
SPEED, YAW_RATE = 0.8, 0.005
TIMING_RUNS = 20

KNN_D2_TOL = 1e-4      # m^2, kernel vs plain
KNN_IDX_AGREE = 0.999  # disagreement allowed only at d2 ties
GN_T_TOL = 1e-3        # m
GN_QDOT_TOL = 1e-6     # |q . q'| >= 1 - tol
LO_STEP_TOL = 0.05     # m per axis, f2f translation vs ground truth
DRIFT_TOL = 0.03       # final position error / path length
# VO f2f motion vs ground truth from frame 2 (tests/test_visual_odometry.py:54-57)
VO_ROT_TOL = 2e-3      # max abs rotation-matrix entry error
VO_COS_MIN = 0.995     # translation direction cosine
VO_SCALE_TOL = 0.15    # relative translation length error


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


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


def gt_delta(poses, i):
    """Ground-truth sensor motion last_T_curr of frame i: (R, t)."""
    (R0, t0), (R1, t1) = poses[i - 1], poses[i]
    return R0.T @ R1, R0.T @ (t1 - t0)


SYNC_WARNING = "called a synchronizing CUDA operation"


class SyncCounter:
    """Counts the synchronising CUDA calls made inside the block: the
    warnings ``torch.cuda.set_sync_debug_mode("warn")`` raises, one per call.
    Other warnings caught meanwhile are kept apart in ``other``."""

    def __enter__(self):
        self._rec = warnings.catch_warnings(record=True)
        self.caught = self._rec.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self._rec.__exit__(*exc)
        self.sites = [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in self.caught
                      if SYNC_WARNING in str(w.message)]
        self.other = sorted({f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}: {str(w.message)[:100]}"
                             for w in self.caught if SYNC_WARNING not in str(w.message)})
        self.count = len(self.sites)
        return False


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run", file=sys.stderr)
        return 1

    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.data import stream
    from vloam_tpu_torch.models import frame_graph as fg
    from vloam_tpu_torch.models.vloam import frame_to_device

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

    cfg = kitti_hdl64()
    ext = fg.kitti_default_extrinsics(dev)
    t0 = time.perf_counter()
    frames, poses = stream.gen_frames(cfg, ext, N_FRAMES, speed=SPEED, yaw_rate=YAW_RATE)
    n_pts = [int(f[2].sum()) for f in frames]
    print(f"host data: {N_FRAMES} frames, {int(np.mean(n_pts))} gridded points/scan on average, "
          f"376x1248 images, {time.perf_counter() - t0:.1f} s (not timed below)")
    dframes = [frame_to_device(*f, dev) for f in frames]

    results = check_kernels(cfg, ext, dframes, card)
    slice_syncs = check_slice(cfg, dframes[:N_SHORT], poses, card)
    launches = check_step(cfg, ext, dframes, poses, card, slice_syncs)
    check_coupled(cfg, ext, dframes[:N_SHORT], poses, card)

    sources = {"knn_pair": ("knn_pair.cu", "vloam_tpu/ops/pallas_knn.py:124"),
               "gn_lidar": ("gn_lidar.cu", "vloam_tpu/ops/pallas_gn.py:138"),
               "gn_vo": ("gn_vo.cu", "vloam_tpu/ops/pallas_gn.py:208"),
               "gather_patches": ("gather_patches.cu", "vloam_tpu/ops/pallas_gather.py:57")}
    kern = [{"name": name, "route": "cuda", "source": f"vloam_tpu_torch/csrc/{src}",
             "replaces": rep, "launches": launches[name], "max_abs_err": results[name]["err"],
             "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
            for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def capture_calls(state, dframes, ext, cfg, keep):
    """Drive ``vloam_step`` over ``dframes`` and record the arguments of
    every kernel-wrapper call made on the frames in ``keep``:
    {(frame, kernel, site): [(args, kwargs), ...]}.  Returns (state, calls)."""
    from vloam_tpu_torch.models import laser_mapping, lidar_odometry, visual_odometry
    from vloam_tpu_torch.models.vloam import vloam_step
    from vloam_tpu_torch.ops import fused_gn, fused_knn, image_ops, patch_gather

    calls = collections.defaultdict(list)
    frame = [0]

    def recorder(key, fn):
        def record(*args, **kw):
            if frame[0] in keep:
                calls[(frame[0],) + key].append((args, kw))
            return fn(*args, **kw)
        return record

    with contextlib.ExitStack() as stack:
        for site, mod in (("LO", lidar_odometry), ("MO", laser_mapping)):
            stack.enter_context(mock.patch.object(
                mod, "knn_pair", recorder(("knn", site), fused_knn.knn_pair)))
            stack.enter_context(mock.patch.object(
                mod, "solve_pose_gn_lidar", recorder(("gn", site), fused_gn.solve_pose_gn_lidar)))
        stack.enter_context(mock.patch.object(
            visual_odometry, "solve_pose_gn_vo",
            recorder(("gn_vo", "VO"), fused_gn.solve_pose_gn_vo)))
        stack.enter_context(mock.patch.object(
            image_ops, "gather_patches_pair",
            recorder(("gather", "KLT"), patch_gather.gather_patches_pair)))
        for i, (img, g, m, bk, lf) in enumerate(dframes):
            frame[0] = i
            state, _ = vloam_step(state, img, g, m, ext, cfg, pre_gridded=True, pre_buckets=bk,
                                  pre_lf_table=lf)
    return state, calls


def check_kernels(cfg, ext, dframes, card):
    """Phase 3; returns {kernel: {"err", "ms", "plain_ms"}}."""
    from vloam_tpu_torch.models.vloam import init_vloam_state
    from vloam_tpu_torch.ops import fused_gn, fused_knn, patch_gather

    last = N_WARMUP - 1
    print(f"== phase 3: kernels vs plain PyTorch versions, at the frame step's call shapes "
          f"(a {N_WARMUP}-frame warm-up drive of the full step; frame 1 and frame {last}) [{card}]")
    state, calls = capture_calls(init_vloam_state(cfg, dframes[0][0].device), dframes[:N_WARMUP],
                                 ext, cfg, keep={1, last})
    del state
    results = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0}
               for k in ("knn_pair", "gn_lidar", "gn_vo", "gather_patches")}

    def timed(name, label, kernel, plain):
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        results[name]["ms"] += ms
        results[name]["plain_ms"] += plain_ms
        print(f"  {name} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(median of {TIMING_RUNS}) [{card}]")

    for site in ("LO", "MO"):
        args, kw = calls[(last, "knn", site)][0]
        qa, ca, _, ka, qb, cb, _, kb = args
        got = fused_knn.knn_pair(*args, **kw)
        ref = fused_knn.knn_pair_reference(*args, **kw)
        torch.cuda.synchronize()
        for g_, r_, q, c, k in ((got[0], ref[0], qa, ca, ka), (got[1], ref[1], qb, cb, kb)):
            shape = f"{site} {q.shape[0]}x{c.shape[0]} k={k}"
            results["knn_pair"]["err"] = max(results["knn_pair"]["err"],
                                             knn_compare(f"knn {shape}", g_, r_))
        timed("knn_pair", f"{site} pair", lambda: fused_knn.knn_pair(*args, **kw),
              lambda: fused_knn.knn_pair_reference(*args, **kw))
    for site in ("LO", "MO"):
        args, _ = calls[(last, "gn", site)][0]
        shape = f"{site} Be={args[1][0].shape[0]} Bs={args[2][0].shape[0]}"
        err = gn_compare(f"gn_lidar {shape}", fused_gn.solve_pose_gn_lidar(*args),
                         fused_gn.solve_pose_gn_lidar_reference(*args))
        results["gn_lidar"]["err"] = max(results["gn_lidar"]["err"], err)
        timed("gn_lidar", shape, lambda: fused_gn.solve_pose_gn_lidar(*args),
              lambda: fused_gn.solve_pose_gn_lidar_reference(*args))

    args, _ = calls[(last, "gn_vo", "VO")][0]
    shape = (f"VO M={args[1].shape[0]} (3D-2D {int(args[4].sum())}, 2D-2D {int(args[5].sum())}), "
             f"{args[6]} iterations")
    results["gn_vo"]["err"] = gn_compare(f"gn_vo {shape}", fused_gn.solve_pose_gn_vo(*args),
                                         fused_gn.solve_pose_gn_vo_reference(*args))
    timed("gn_vo", shape, lambda: fused_gn.solve_pose_gn_vo(*args),
          lambda: fused_gn.solve_pose_gn_vo_reference(*args))

    gathers = calls[(1, "gather", "KLT")]
    assert len(gathers) == 3, f"frame 1 made {len(gathers)} patch gathers, want 3"
    level0 = calls[(last, "gather", "KLT")]
    assert len(level0) == 1, f"frame {last} made {len(level0)} patch gathers, want 1"
    for label, (args, _) in (("frame 1 level 2", gathers[0]), ("frame 1 level 1", gathers[1]),
                             (f"frame {last} level 0", level0[0])):
        got = patch_gather.gather_patches_pair(*args)
        ref = patch_gather.gather_patches_pair_reference(*args)
        torch.cuda.synchronize()
        for g_, r_ in zip(got, ref):
            assert torch.equal(g_, r_), f"gather_patches {label}: kernel differs from plain"
        img = args[0]
        print(f"  gather_patches {label} {tuple(img.shape)} -> 2x{tuple(got[0].shape)}: "
              f"bit-equal to the plain version")
        if label.endswith("level 0"):
            timed("gather_patches", f"{label} {tuple(img.shape)} N={got[0].shape[0]}",
                  lambda: patch_gather.gather_patches_pair(*args),
                  lambda: patch_gather.gather_patches_pair_reference(*args))
    return results


def drive(step, state, dframes, counters):
    """Run ``step`` over the frames: (state, outputs, ms per frame, per-frame
    launch counts {counter: [n, ...]}, synchronising calls on SYNC_FRAME)."""
    outs, frame_ms = [], []
    per_frame = {name: [] for name in counters}
    syncs = None
    for i, f in enumerate(dframes):
        before = {name: get() for name, get in counters.items()}
        t0 = time.perf_counter()
        with SyncCounter() if i == SYNC_FRAME else contextlib.nullcontext() as sc:
            state, out = step(state, f)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if sc is not None:
            syncs = sc
        for name, get in counters.items():
            per_frame[name].append(get() - before[name])
        outs.append(out)
    return state, outs, frame_ms, per_frame, syncs


def check_lidar(outs, poses, what, names=("world_lo", "world_mo", "lo_delta")):
    """Finite outputs, LO f2f within LO_STEP_TOL from frame 1, final LO and
    MO error within DRIFT_TOL of the path.  Returns (worst step, lo, mo, path)."""
    worst_step = 0.0
    for i, out in enumerate(outs):
        for name in names:
            v = getattr(out, name)
            assert bool(torch.isfinite(v).all()), f"{what} frame {i}: non-finite {name} {v}"
        if i >= 1:
            step_err = float(np.abs(out.lo_delta[4:].cpu().numpy() - gt_delta(poses, i)[1]).max())
            worst_step = max(worst_step, step_err)
            assert step_err < LO_STEP_TOL, f"{what} frame {i}: LO f2f translation off by {step_err} m"
    gt_end = poses[len(outs) - 1][1]
    path = SPEED * (len(outs) - 1)
    lo_err = float(np.linalg.norm(outs[-1].world_lo[4:].cpu().numpy() - gt_end))
    mo_err = float(np.linalg.norm(outs[-1].world_mo[4:].cpu().numpy() - gt_end))
    assert lo_err / path <= DRIFT_TOL, f"{what}: LO drift {lo_err} m over {path} m"
    assert mo_err / path <= DRIFT_TOL, f"{what}: MO drift {mo_err} m over {path} m"
    print(f"  LO f2f translation: worst axis error {worst_step * 100:.2f} cm (bound "
          f"{LO_STEP_TOL * 100:.0f} cm); final error LO {lo_err:.3f} m ({lo_err / path * 100:.2f} %), "
          f"MO {mo_err:.3f} m ({mo_err / path * 100:.2f} %) over {path:.1f} m")
    return worst_step, lo_err, mo_err, path


def ms_line(frame_ms, first, card):
    steady = frame_ms[first:]
    return (f"ms/frame (host clock, synchronised, frames {first}..{len(frame_ms) - 1}): median "
            f"{statistics.median(steady):.3f}, min {min(steady):.3f}, max {max(steady):.3f}; "
            f"frame 0 {frame_ms[0]:.3f} [{card}]")


def fresh_device(dev):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)


def check_slice(cfg, dframes, poses, card):
    """Phase 4: the lidar slice alone.  Returns its SyncCounter on SYNC_FRAME."""
    from vloam_tpu_torch.models.lidar_slice import init_lidar_state, lidar_step
    from vloam_tpu_torch.ops import fused_gn, fused_knn

    print(f"== phase 4: lidar slice, kitti_hdl64, {len(dframes)} frames [{card}]")
    dev = dframes[0][0].device
    fresh_device(dev)
    counters = {"knn_pair": lambda: fused_knn.LAUNCHES, "gn_lidar": lambda: fused_gn.LAUNCHES}
    state, outs, frame_ms, per_frame, syncs = drive(
        lambda s, f: lidar_step(s, f[1], f[2], f[4], cfg), init_lidar_state(cfg, dev), dframes,
        counters)
    for i in range(1, len(dframes)):
        got = (per_frame["knn_pair"][i], per_frame["gn_lidar"][i])
        assert got == (4, 4), f"slice frame {i}: {got} knn_pair/gn_lidar launches, want 4 and 4"
    check_lidar(outs, poses, "slice")
    print(f"  {ms_line(frame_ms, 5, card)}")
    print(f"  synchronising calls in frame {SYNC_FRAME}: {syncs.count} ({', '.join(syncs.sites)})"
          + (f"; other warnings: {syncs.other}" if syncs.other else ""))
    del state
    return syncs


def check_step(cfg, ext, dframes, poses, card, slice_syncs):
    """Phase 5: the full step in (D); returns the launch totals of the run."""
    from vloam_tpu_torch.models.vloam import init_vloam_state, vloam_step
    from vloam_tpu_torch.ops import fused_gn, fused_knn, patch_gather

    print(f"== phase 5: full step vloam_step (D), kitti_hdl64, {len(dframes)} frames [{card}]")
    dev = dframes[0][0].device
    fresh_device(dev)
    state = init_vloam_state(cfg, dev)
    print(f"  map on device: cube array {tuple(state.mp.cube_pts.shape)} "
          f"({state.mp.cube_pts.numel() * 4 / 2**20:.0f} MiB)")
    counters = {"knn_pair": lambda: fused_knn.LAUNCHES, "gn_lidar": lambda: fused_gn.LAUNCHES,
                "gn_vo": lambda: fused_gn.LAUNCHES_VO,
                "gather_patches": lambda: patch_gather.LAUNCHES}
    fused_knn.LAUNCHES = fused_gn.LAUNCHES = fused_gn.LAUNCHES_VO = patch_gather.LAUNCHES = 0

    def step(s, f):
        img, g, m, bk, lf = f
        return vloam_step(s, img, g, m, ext, cfg, pre_gridded=True, pre_buckets=bk,
                          pre_lf_table=lf)

    state, outs, frame_ms, per_frame, syncs = drive(step, state, dframes, counters)
    launches = {name: get() for name, get in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)

    for i in range(len(dframes)):
        got = {name: per_frame[name][i] for name in counters}
        want = {"knn_pair": 4 if i else 0, "gn_lidar": 4 if i else 0, "gn_vo": 1,
                "gather_patches": 3 if i < 2 else 1}
        assert got == want, f"step frame {i}: launches {got}, want {want}"
    for i, out in enumerate(outs):
        for name, v in out._asdict().items():
            assert bool(torch.isfinite(v.to(torch.float32)).all()), f"frame {i}: non-finite {name} {v}"
    check_lidar(outs, poses, "step")

    from vloam_tpu_torch import geometry as geo
    worst = {"rot": 0.0, "cos": 1.0, "scale": 0.0}
    for i in range(2, len(outs)):
        R_rel, t_rel = gt_delta(poses, i)
        d = outs[i].vo_delta.cpu()
        rot = float(np.abs(geo.quat_to_matrix(d[:4]).numpy() - R_rel).max())
        est_t = d[4:].numpy().astype(np.float64)
        cos = float(est_t @ t_rel / (np.linalg.norm(est_t) * np.linalg.norm(t_rel)))
        scale = abs(np.linalg.norm(est_t) - np.linalg.norm(t_rel)) / np.linalg.norm(t_rel)
        assert rot < VO_ROT_TOL and cos > VO_COS_MIN and scale < VO_SCALE_TOL, \
            f"frame {i}: VO f2f rotation error {rot}, direction cos {cos}, scale error {scale}"
        worst = {"rot": max(worst["rot"], rot), "cos": min(worst["cos"], cos),
                 "scale": max(worst["scale"], scale)}
    path = SPEED * (len(outs) - 1)
    vo_err = float(np.linalg.norm(outs[-1].world_vo[4:].cpu().numpy() - poses[len(outs) - 1][1]))
    assert syncs.count <= slice_syncs.count, \
        f"frame {SYNC_FRAME}: {syncs.count} synchronising calls, the slice alone makes {slice_syncs.count}"
    mp = state.mp
    print(f"  launches per frame: {', '.join(f'{k} {v[:3]}...' for k, v in per_frame.items())}; "
          f"totals {launches}")
    print(f"  VO f2f from frame 2: worst rotation entry error {worst['rot']:.2e} (bound {VO_ROT_TOL}), "
          f"direction cos {worst['cos']:.6f} (> {VO_COS_MIN}), scale error {worst['scale'] * 100:.2f} % "
          f"(< {VO_SCALE_TOL * 100:.0f} %); final error VO {vo_err:.3f} m "
          f"({vo_err / path * 100:.2f} %) over {path:.1f} m")
    print(f"  map: {int(mp.corner_cnt.sum())} corner + {int(mp.surf_cnt.sum())} surf points; "
          f"submap cache {int(mp.sub_c_n)} + {int(mp.sub_s_n)}")
    print(f"  {ms_line(frame_ms, 5, card)}; peak device memory {peak / 2**20:.1f} MiB")
    print(f"  synchronising calls in frame {SYNC_FRAME}: {syncs.count} ({', '.join(syncs.sites)}); "
          f"the slice alone: {slice_syncs.count}"
          + (f"; other warnings: {syncs.other}" if syncs.other else ""))
    del state
    return launches


def check_coupled(cfg, ext, dframes, poses, card):
    """Phase 6: the coupled (C) mode."""
    from vloam_tpu_torch.models.vloam import init_vloam_state, vloam_step

    print(f"== phase 6: full step vloam_step (C), kitti_hdl64, {len(dframes)} frames [{card}]")
    ccfg = cfg.replace(detach_vo_lo=False)
    fresh_device(dframes[0][0].device)

    def step(s, f):
        img, g, m, bk, lf = f
        return vloam_step(s, img, g, m, ext, ccfg, pre_gridded=True, pre_buckets=bk,
                          pre_lf_table=lf)

    state, outs, frame_ms, _, _ = drive(step, init_vloam_state(ccfg, dframes[0][0].device),
                                        dframes, {})
    for i, out in enumerate(outs):
        for name, v in out._asdict().items():
            assert bool(torch.isfinite(v.to(torch.float32)).all()), f"(C) frame {i}: non-finite {name}"
    check_lidar(outs, poses, "coupled")
    print(f"  {ms_line(frame_ms, 5, card)}")
    del state


if __name__ == "__main__":
    sys.exit(main())
