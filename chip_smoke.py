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
   single-problem k-NN on each group of the MO call (also against the pair
   kernel, bit for bit; ``nn1``; one k outside the register instantiations)
   and the map association built on it, the VO GN solve on a tracked frame,
   and the KLT patch gather at the two coarse pyramid levels of frame 1 and
   at level 0 of a tracked frame; with the tolerances below, the median
   times of both (CUDA events, 20 runs) and each kernel's roofline bound.
   Then (3b) the single-problem map association path, driven with the
   launch counts at 0: MO's two outer iterations with one k-NN launch per
   feature type, against the fused path from the same pose;
4. the lidar slice (scan registration -> LO -> MO) alone, 12 frames;
5. the full step ``vloam_step`` in the decoupled (D) mode at full
   ``kitti_hdl64`` width with the whole map on the device: 40 frames of
   the ``bench._gen_frames`` course (synthetic HDL-64 scans of ~100k points
   and 376x1248 blob images along a gently turning street, crossing the
   x = 25 m cube boundary near frame 32), checked against ground truth, the
   kernels' launch counts and the slice's count of synchronising calls;
6. the coupled (C) mode, 12 frames of the same course;
7. the runtime entry point: ``runtime.driver.run_synthetic`` over 40 full
   frames (raw clouds and images in, three KITTI trajectory files out),
   checked against ground truth, phase 5's launch counts, and the count of
   synchronising calls of a steady frame; VloamDriver's stage times;
8. checkpoint and resume (12 frames, a checkpoint at 6, a fresh driver
   resumed from it) and the CLI in a subprocess.

Then one JSON line of per-kernel results, the card's name and power limit,
and last the line ``{"ok": true, "device": {...}}``.  Any failure raises
and exits nonzero before that line; so does a machine without CUDA.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# resumed vs uninterrupted run on the card: float atomics in the scatter ops
# order their sums differently from run to run, which moves a few map-insert
# decisions, so the two agree like two uninterrupted runs do (phase 8 prints
# that spread too), not bit for bit.  The bound is the one the CPU tests hold
# the port's exported rows to against the reference.
RESUME_TOL = 5e-3      # m, final MO position and every exported row entry
N_RESUME, CKPT_AT = 12, 6

# published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32 = 67e12       # FLOP/s
PEAK_BW = 3.35e12      # bytes/s
KNN_PAIR_OPS = 9       # per (live query, live candidate): 3 sub, 3 mul, 2 add, 1 compare
GN_LIDAR_OPS = 100     # per live residual and iteration (csrc/gn_lidar.cu)
GN_VO_OPS = 150        # per live match and iteration (csrc/gn_vo.cu)

KERNELS = {   # name: (source under vloam_tpu_torch/csrc, the TPU kernel it replaces)
    "knn_pair": ("knn_pair.cu", "vloam_tpu/ops/pallas_knn.py:124"),
    "knn": ("knn.cu", "vloam_tpu/ops/pallas_knn.py:53"),
    "gn_lidar": ("gn_lidar.cu", "vloam_tpu/ops/pallas_gn.py:138"),
    "gn_vo": ("gn_vo.cu", "vloam_tpu/ops/pallas_gn.py:208"),
    "gather_patches": ("gather_patches.cu", "vloam_tpu/ops/pallas_gather.py:57"),
}


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

    results, calls = check_kernels(cfg, ext, dframes, card)
    launches = {"knn": check_single_association(cfg, calls, card)}
    del calls
    slice_syncs = check_slice(cfg, dframes[:N_SHORT], poses, card)
    step_launches, per_frame, step_syncs = check_step(cfg, ext, dframes, poses, card, slice_syncs)
    launches.update(step_launches)
    check_coupled(cfg, ext, dframes[:N_SHORT], poses, card)
    del dframes
    check_driver(cfg, card, per_frame, step_syncs)
    check_resume(cfg, ext, frames[:N_RESUME], card)
    check_cli(card)

    kern = []
    for name, (src, rep) in KERNELS.items():
        assert launches[name] > 0, f"{name}: not launched on its path"
        r = results[name]
        kern.append({"name": name, "route": "cuda", "source": f"vloam_tpu_torch/csrc/{src}",
                     "replaces": rep, "launches": launches[name], "max_abs_err": r["err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": max(r["ops_ms"], r["bytes_ms"]),
                     "bound_by": "operations" if r["ops_ms"] >= r["bytes_ms"] else "bytes",
                     "library_ms": None})
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


def knn_work(q, cand, mask, k, q_count, c_count):
    """(operations, bytes) of one k-NN problem on these inputs: KNN_PAIR_OPS
    per (live query, live candidate) pair; queries, candidates and mask read
    once, (d2 f32, idx int64) written once."""
    m, n = q.shape[0], cand.shape[0]
    live_q = m if q_count is None else int(q_count)
    c_n = n if c_count is None else int(c_count)
    live_c = int(mask[:c_n].sum())
    return KNN_PAIR_OPS * live_q * live_c, 12 * (m + n) + n + 12 * m * k


def check_kernels(cfg, ext, dframes, card):
    """Phase 3; returns ({kernel: {"err", "ms", "plain_ms", "ops_ms",
    "bytes_ms"}}, the captured calls).  Times add up over the call shapes
    timed for a kernel, and so do the two roofline times (operations over
    PEAK_F32, bytes over PEAK_BW) of the same calls."""
    from vloam_tpu_torch.models.vloam import init_vloam_state
    from vloam_tpu_torch.ops import fused_gn, fused_knn, knn, patch_gather

    last = N_WARMUP - 1
    print(f"== phase 3: kernels vs plain PyTorch versions, at the frame step's call shapes "
          f"(a {N_WARMUP}-frame warm-up drive of the full step; frame 1 and frame {last}) [{card}]")
    state, calls = capture_calls(init_vloam_state(cfg, dframes[0][0].device), dframes[:N_WARMUP],
                                 ext, cfg, keep={1, last})
    del state
    results = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0}
               for k in KERNELS}

    def timed(name, label, kernel, plain, ops, nbytes):
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        ops_ms, bytes_ms = ops / PEAK_F32 * 1e3, nbytes / PEAK_BW * 1e3
        r = results[name]
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["ops_ms"] += ops_ms
        r["bytes_ms"] += bytes_ms
        print(f"  {name} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(median of {TIMING_RUNS}); bound {max(ops_ms, bytes_ms):.5f} ms "
              f"({ops / 1e6:.2f} MFLOP -> {ops_ms:.5f} ms, {nbytes / 1e6:.3f} MB -> "
              f"{bytes_ms:.5f} ms) [{card}]")
        return ms

    def cdist_topk(label, q, cand, k):
        ms = time_ms(lambda: torch.topk(torch.cdist(q[None], cand[None])[0], k, dim=1,
                                        largest=False))
        print(f"  library yardstick {label}: torch.cdist + torch.topk {ms:.4f} ms (TWO calls, no "
              f"mask and no dynamic counts, full {q.shape[0]}x{cand.shape[0]}; no single "
              f"PyTorch call computes this k-NN) [{card}]")

    pair_ms = {}
    for site in ("LO", "MO"):
        args, kw = calls[(last, "knn", site)][0]
        qa, ca, ma, ka, qb, cb, mb, kb = args
        ac, bc = kw.get("a_counts", (None, None)), kw.get("b_counts", (None, None))
        got = fused_knn.knn_pair(*args, **kw)
        ref = fused_knn.knn_pair_reference(*args, **kw)
        torch.cuda.synchronize()
        work = []
        for g_, r_, q, c, m, k, cnt in ((got[0], ref[0], qa, ca, ma, ka, ac),
                                        (got[1], ref[1], qb, cb, mb, kb, bc)):
            shape = f"{site} {q.shape[0]}x{c.shape[0]} k={k}"
            results["knn_pair"]["err"] = max(results["knn_pair"]["err"],
                                             knn_compare(f"knn_pair {shape}", g_, r_))
            work.append(knn_work(q, c, m, k, *cnt))
            cdist_topk(shape, q, c, k)
        pair_ms[site] = timed("knn_pair", f"{site} pair", lambda: fused_knn.knn_pair(*args, **kw),
                              lambda: fused_knn.knn_pair_reference(*args, **kw),
                              work[0][0] + work[1][0], work[0][1] + work[1][1])

    # the single-problem kernel on each group of the MO call
    args, kw = calls[(last, "knn", "MO")][0]
    qa, ca, ma, ka, qb, cb, mb, kb = args
    pair = fused_knn.knn_pair(*args, **kw)
    single_ms = 0.0
    for grp, (q, c, m, k, cnt) in enumerate(((qa, ca, ma, ka, kw["a_counts"]),
                                             (qb, cb, mb, kb, kw["b_counts"]))):
        shape = f"MO {q.shape[0]}x{c.shape[0]} k={k}"
        one = lambda: knn.knn(q, c, m, k, cand_count=cnt[1], query_count=cnt[0])  # noqa: E731
        ref = lambda: knn.knn_reference(q, c, m, k, cand_count=cnt[1], query_count=cnt[0])  # noqa: E731
        got = one()
        torch.cuda.synchronize()
        results["knn"]["err"] = max(results["knn"]["err"], knn_compare(f"knn {shape}", got, ref()))
        assert torch.equal(got[0], pair[grp][0]) and torch.equal(got[1], pair[grp][1]), \
            f"knn {shape}: differs from the same group of one knn_pair launch"
        d1, i1 = knn.nn1(q, c, m, cand_count=cnt[1], query_count=cnt[0])
        assert torch.equal(d1, got[0][:, 0]) and torch.equal(i1, got[1][:, 0]), \
            f"nn1 {shape}: differs from column 0 of k={k}"
        print(f"  knn {shape}: bit-equal to its knn_pair group; nn1 equals column 0")
        single_ms += timed("knn", shape, one, ref, *knn_work(q, c, m, k, cnt[0], cnt[1]))
    print(f"  knn, both MO groups one after the other {single_ms:.4f} ms; the same two problems in "
          f"one knn_pair launch {pair_ms['MO']:.4f} ms [{card}]")
    q, c, m = qb[:1024].contiguous(), cb[:8192].contiguous(), mb[:8192].contiguous()
    results["knn"]["err"] = max(results["knn"]["err"], knn_compare(
        "knn 1024x8192 k=32 (run-time k)", knn.knn(q, c, m, 32), knn.knn_reference(q, c, m, 32)))

    gn_args, _ = calls[(last, "gn", "MO")][0]
    check_correspondences(cfg, args, kw, gn_args)

    for site in ("LO", "MO"):
        args, _ = calls[(last, "gn", site)][0]
        (_, _, _, v_e), (_, _, _, v_s), iters = args[1], args[2], args[3]
        be, bs = v_e.shape[0], v_s.shape[0]
        shape = f"{site} Be={be} Bs={bs}"
        err = gn_compare(f"gn_lidar {shape}", fused_gn.solve_pose_gn_lidar(*args),
                         fused_gn.solve_pose_gn_lidar_reference(*args))
        results["gn_lidar"]["err"] = max(results["gn_lidar"]["err"], err)
        # rows: an edge is 10 floats, a plane 8 (csrc/gn_lidar.cu); pose in and out
        timed("gn_lidar", shape, lambda: fused_gn.solve_pose_gn_lidar(*args),
              lambda: fused_gn.solve_pose_gn_lidar_reference(*args),
              GN_LIDAR_OPS * (int(v_e.sum()) + int(v_s.sum())) * iters,
              4 * (10 * be + 8 * bs + 14))

    args, _ = calls[(last, "gn_vo", "VO")][0]
    n32, n22, m_vo = int(args[4].sum()), int(args[5].sum()), args[1].shape[0]
    shape = f"VO M={m_vo} (3D-2D {n32}, 2D-2D {n22}), {args[6]} iterations"
    results["gn_vo"]["err"] = gn_compare(f"gn_vo {shape}", fused_gn.solve_pose_gn_vo(*args),
                                         fused_gn.solve_pose_gn_vo_reference(*args))
    timed("gn_vo", shape, lambda: fused_gn.solve_pose_gn_vo(*args),
          lambda: fused_gn.solve_pose_gn_vo_reference(*args),
          GN_VO_OPS * (n32 + n22) * args[6], 4 * (9 * m_vo + 14))

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
            # a pure copy: both images and the corners read once, both patch stacks written once
            nbytes = 2 * img.numel() * 4 + 2 * got[0].shape[0] * 8 + 2 * got[0].numel() * 4
            timed("gather_patches", f"{label} {tuple(img.shape)} N={got[0].shape[0]}",
                  lambda: patch_gather.gather_patches_pair(*args),
                  lambda: patch_gather.gather_patches_pair_reference(*args), 0, nbytes)
    print("  library_ms is null for every kernel: no single PyTorch call computes a masked k-NN "
          "with dynamic counts, a fused Gauss-Newton solve, or the two-image window copy")
    return results, calls


def association_inputs(knn_args, knn_kw, gn_args):
    """What the single-problem map association takes, from one outer
    iteration's captured knn_pair and GN calls: the pose, and per feature
    type (stack xyz, stack mask, candidates, candidate mask, counts)."""
    qa, ca, ma, _, qb, cb, mb, _ = knn_args
    pose, (p_e, _, _, _), (p_s, _, _, _) = gn_args[0], gn_args[1], gn_args[2]
    dev = pose.device
    ac, bc = knn_kw["a_counts"], knn_kw["b_counts"]
    # the voxel-downsampled stacks are prefix-compacted: the mask is the count
    cs_mask = torch.arange(p_e.shape[0], device=dev) < ac[0]
    ss_mask = torch.arange(p_s.shape[0], device=dev) < bc[0]
    return pose, (p_e, cs_mask, ca, ma, ac), (p_s, ss_mask, cb, mb, bc)


def check_correspondences(cfg, knn_args, knn_kw, gn_args):
    """The map association through the single-problem kernel against the
    fused path's fit outputs (what it handed the GN solve) at the same pose."""
    from vloam_tpu_torch.models import laser_mapping as lm

    pose, corner, surf = association_inputs(knn_args, knn_kw, gn_args)
    for name, fn, (stack, smask, cand, cmask, cnt), want in (
            ("_corner_correspondences", lm._corner_correspondences, corner, gn_args[1]),
            ("_surf_correspondences", lm._surf_correspondences, surf, gn_args[2])):
        got = fn(pose, stack, smask, cand, cmask, cfg, cand_count=cnt[1], query_count=cnt[0])
        torch.cuda.synchronize()
        assert torch.equal(got[3], want[3]), f"{name}: valid mask differs from the fused path's"
        for i in (0, 1, 2):
            assert torch.equal(got[i], want[i]), f"{name}: output {i} differs from the fused path's"
        print(f"  {name}: {int(got[3].sum())} valid of {int(smask.sum())} live queries; points, "
              f"fits and valid mask bit-equal to the fused path's")


def check_single_association(cfg, calls, card):
    """Phase 3b: the path of the single-problem kernel.  MO's optimisation
    (two outer iterations of association + fits + fused GN) with one k-NN
    launch per feature type, from the captured pose and submap of the last
    warm-up frame, against the same loop through ``knn_pair``.  Returns the
    kernel's launches on this path."""
    from vloam_tpu_torch.models import laser_mapping as lm
    from vloam_tpu_torch.ops import fused_gn, fused_knn, knn

    last = N_WARMUP - 1
    print(f"== phase 3b: single-problem map association path (MO of frame {last}) [{card}]")
    (knn_args, knn_kw), (gn_args, _) = calls[(last, "knn", "MO")][0], calls[(last, "gn", "MO")][0]
    pose0, corner, surf = association_inputs(knn_args, knn_kw, gn_args)
    mc = cfg.mapping
    stack4 = lambda xyz: torch.cat([xyz, torch.zeros_like(xyz[:, :1])], dim=1)  # noqa: E731
    c_stack, s_stack = stack4(corner[0]), stack4(surf[0])

    def single(pose):
        for _ in range(mc.outer_iters):
            e = lm._corner_correspondences(pose, c_stack, corner[1], corner[2], corner[3], cfg,
                                           cand_count=corner[4][1], query_count=corner[4][0])
            s = lm._surf_correspondences(pose, s_stack, surf[1], surf[2], surf[3], cfg,
                                         cand_count=surf[4][1], query_count=surf[4][0])
            pose = fused_gn.solve_pose_gn_lidar(pose, e[:4], s[:4], mc.inner_iters,
                                                mc.huber_delta, mc.lm_lambda)
        return pose, e[4], s[4]

    def fused(pose):
        for _ in range(mc.outer_iters):
            qc, qs = lm.geo.pose_apply(pose, corner[0]), lm.geo.pose_apply(pose, surf[0])
            (d2c, ic), (d2s, i_s) = fused_knn.knn_pair(
                qc, corner[2], corner[3], mc.n_neighbors, qs, surf[2], surf[3], mc.n_neighbors,
                a_counts=corner[4], b_counts=surf[4])
            e = lm.fit_corner_lines(c_stack, corner[1], corner[2][ic], d2c, cfg)
            s = lm.fit_surf_planes(s_stack, surf[1], surf[2][i_s], d2s, cfg)
            pose = fused_gn.solve_pose_gn_lidar(pose, e, s, mc.inner_iters, mc.huber_delta,
                                                mc.lm_lambda)
        return pose, d2c[:, 0], d2s[:, 0]

    knn.LAUNCHES = 0
    t0 = time.perf_counter()
    pose_1, nn_c1, nn_s1 = single(pose0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = knn.LAUNCHES
    pose_2, nn_c2, nn_s2 = fused(pose0)
    torch.cuda.synchronize()
    assert launches == 2 * mc.outer_iters, f"{launches} knn launches, want {2 * mc.outer_iters}"
    assert bool(torch.isfinite(pose_1).all())
    gn_compare("MO pose, single-problem path vs fused path", pose_1, pose_2)
    assert torch.equal(nn_c1, nn_c2) and torch.equal(nn_s1, nn_s2), \
        "1-NN distances for the insert gate differ between the two paths"
    moved = float((pose_1[4:] - pose0[4:]).norm())
    print(f"  {launches} knn launches; pose moved {moved * 1e3:.3f} mm from the initial guess; "
          f"1-NN gate distances bit-equal; {ms:.2f} ms for the loop (host clock) [{card}]")
    return launches


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
    """Phase 5: the full step in (D); returns (the launch totals of the run,
    the launches per frame, the SyncCounter of SYNC_FRAME)."""
    from vloam_tpu_torch.models.vloam import init_vloam_state, vloam_step
    from vloam_tpu_torch.ops import fused_gn, fused_knn, patch_gather

    print(f"== phase 5: full step vloam_step (D), kitti_hdl64, {len(dframes)} frames [{card}]")
    dev = dframes[0][0].device
    fresh_device(dev)
    state = init_vloam_state(cfg, dev)
    print(f"  map on device: cube array {tuple(state.mp.cube_pts.shape)} "
          f"({state.mp.cube_pts.numel() * 4 / 2**20:.0f} MiB)")
    counters = launch_counters()
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
    return launches, per_frame, syncs


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


def launch_counters():
    from vloam_tpu_torch.ops import fused_gn, fused_knn, patch_gather

    return {"knn_pair": lambda: fused_knn.LAUNCHES, "gn_lidar": lambda: fused_gn.LAUNCHES,
            "gn_vo": lambda: fused_gn.LAUNCHES_VO, "gather_patches": lambda: patch_gather.LAUNCHES}


def gt_rows(poses):
    """Ground-truth KITTI rows cam0_start_T_cam0_curr (N, 3, 4) of the sensor
    poses (R, t), through the nominal velodyne-to-camera rotation."""
    from vloam_tpu_torch.models.frame_graph import kitti_default_extrinsics
    from vloam_tpu_torch import geometry as geo

    velo_R_cam = geo.quat_to_matrix(kitti_default_extrinsics("cpu").velo_T_cam0[:4]).numpy()
    velo_R_cam = velo_R_cam.astype(np.float64)
    R0, t0 = poses[0]
    rows = []
    for R, t in poses:
        R_rel, t_rel = R0.T @ R, R0.T @ (t - t0)            # start_T_curr in the sensor frame
        rows.append(np.concatenate([velo_R_cam.T @ R_rel @ velo_R_cam,
                                    (velo_R_cam.T @ t_rel)[:, None]], axis=1))
    return np.stack(rows)


def check_driver(cfg, card, step_per_frame, step_syncs):
    """Phase 7: the runtime entry point on the card."""
    from vloam_tpu_torch.data import synthetic
    from vloam_tpu_torch.ops import fused_gn, fused_knn, patch_gather
    from vloam_tpu_torch.runtime import driver as drv
    from vloam_tpu_torch.utils.trajectory import load_kitti_trajectory

    print(f"== phase 7: runtime.driver.run_synthetic, kitti_hdl64, {N_FRAMES} frames, "
          f"n_azimuth=1800 [{card}]")
    fresh_device(torch.device("cuda", 0))
    counters = launch_counters()
    per_frame = {name: [] for name in counters}
    seen = {}
    process = drv.VloamDriver.process

    def counted(self, image, cloud):
        before = {name: get() for name, get in counters.items()}
        with SyncCounter() if self.count == SYNC_FRAME else contextlib.nullcontext() as sc:
            out = process(self, image, cloud)
        for name, get in counters.items():
            per_frame[name].append(get() - before[name])
        seen["driver"] = self
        if sc is not None:
            seen["syncs"] = sc
        return out

    fused_knn.LAUNCHES = fused_gn.LAUNCHES = fused_gn.LAUNCHES_VO = patch_gather.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as out_dir, \
            mock.patch.object(drv.VloamDriver, "process", counted):
        t0 = time.perf_counter()
        res = drv.run_synthetic(cfg, n_frames=N_FRAMES, speed=SPEED, yaw_rate=YAW_RATE,
                                out_dir=out_dir, n_azimuth=1800, verbose=False)
        wall = time.perf_counter() - t0
        trajs = {name: load_kitti_trajectory(os.path.join(out_dir, f"{name}1.txt"))
                 for name in ("VO", "LO", "MO")}
        for name in trajs:
            with open(os.path.join(out_dir, f"{name}1.txt")) as f:
                lines = f.read().splitlines()
            assert len(lines) == N_FRAMES and all(len(ln.split()) == 12 for ln in lines), \
                f"{name}1.txt: want {N_FRAMES} rows of 12 numbers"
    driver, syncs = seen["driver"], seen["syncs"]
    assert driver.device.type == "cuda" and driver.state.mp.cube_pts.is_cuda

    assert per_frame == step_per_frame, \
        f"launches per frame differ from phase 5: {per_frame} vs {step_per_frame}"
    gt = gt_rows(synthetic.straight_trajectory(N_FRAMES, speed=SPEED, yaw_rate=YAW_RATE))
    path = res["path_len_m"]
    errs = {}
    for name, traj in trajs.items():
        assert traj.shape == (N_FRAMES, 3, 4) and np.isfinite(traj).all(), f"{name}: bad rows"
        errs[name] = float(np.linalg.norm(traj[-1, :, 3] - gt[-1, :, 3]))
    for name in ("LO", "MO"):
        assert errs[name] / path <= DRIFT_TOL, f"{name}1.txt: final error {errs[name]} m over {path} m"
    for name, key in (("LO", "final_err_lo_m"), ("MO", "final_err_mo_m")):
        # the f64 file and the device's f32 chain tell the same story
        assert abs(errs[name] - res[key]) < 1e-3, f"{name}: file {errs[name]} vs device {res[key]}"
    assert syncs.count <= step_syncs.count + 1, \
        f"frame {SYNC_FRAME}: {syncs.count} synchronising calls, the step makes {step_syncs.count}"
    print(f"  three files of {N_FRAMES} rows x 12; final position error vs ground truth over "
          f"{path:.1f} m: " + ", ".join(f"{n} {e:.3f} m ({e / path * 100:.2f} %)"
                                        for n, e in errs.items()) + f" (bound {DRIFT_TOL * 100:.0f} % for LO, MO)")
    print(f"  f32 device chain vs f64 host chain, largest divergence: "
          + ", ".join(f"{k} {v * 1e3:.4f} mm" for k, v in driver.f32_divergence_m.items()))
    print(f"  launches per frame equal phase 5's: "
          f"{', '.join(f'{k} {v[:3]}...' for k, v in per_frame.items())}")
    print(f"  synchronising calls in frame {SYNC_FRAME}: {syncs.count} ({', '.join(syncs.sites)}); "
          f"the step alone: {step_syncs.count}"
          + (f"; other warnings: {syncs.other}" if syncs.other else ""))
    print(f"  stage times (host clock) [{card}]:")
    for line in driver.timer.summary().splitlines():
        print(f"    {line}")
    print(f"  steady_ms_per_frame {res['steady_ms_per_frame']:.3f} (median of process(), frames "
          f"2..{N_FRAMES - 1}), fps {res['fps']:.2f}; whole run {wall:.1f} s with the host's "
          f"scan and image synthesis [{card}]")
    del driver, seen


def check_resume(cfg, ext, frames, card):
    """Phase 8a: checkpoint at CKPT_AT, restore into a fresh driver, finish;
    against the run that was never interrupted."""
    from vloam_tpu_torch.runtime.driver import VloamDriver
    from vloam_tpu_torch.utils.trajectory import load_kitti_trajectory

    print(f"== phase 8: checkpoint at frame {CKPT_AT} of {len(frames)}, resume, and the CLI [{card}]")
    fresh_device(torch.device("cuda", 0))
    names = ("VO1.txt", "LO1.txt", "MO1.txt")
    with tempfile.TemporaryDirectory() as tmp:
        dir_a, dir_b, dir_c, ck = (os.path.join(tmp, d) for d in ("a", "b", "c", "ck"))
        da = VloamDriver(cfg, ext, out_dir=dir_a, checkpoint_dir=ck, checkpoint_every=CKPT_AT)
        t0 = time.perf_counter()
        for img, grid, gmask, _, _ in frames:
            da.process_grid(img, grid, gmask)
        da.close()
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        path = os.path.join(ck, f"ckpt_{CKPT_AT:06d}")
        size = os.path.getsize(path) + os.path.getsize(path + "_driver.npz")
        final_a = da.host_out.world_mo.copy()
        del da
        fresh_device(torch.device("cuda", 0))

        shutil.copytree(dir_a, dir_b)        # the files as a crash after the last frame leaves them
        db = VloamDriver(cfg, ext, out_dir=dir_b)
        start = db.restore_checkpoint(path)
        assert start == CKPT_AT and db.state.count == CKPT_AT and db.state.mp.cube_pts.is_cuda
        for img, grid, gmask, _, _ in frames[start:]:
            db.process_grid(img, grid, gmask)
        db.close()
        final_b = db.host_out.world_mo.copy()
        del db
        fresh_device(torch.device("cuda", 0))

        # the same 12 frames once more, uninterrupted: the run-to-run spread
        dc = VloamDriver(cfg, ext, out_dir=dir_c)
        for img, grid, gmask, _, _ in frames:
            dc.process_grid(img, grid, gmask)
        dc.close()
        del dc

        worst = spread = 0.0
        for name in names:
            with open(os.path.join(dir_a, name)) as fa, open(os.path.join(dir_b, name)) as fb:
                la, lb = fa.read().splitlines(), fb.read().splitlines()
            assert len(la) == len(lb) == len(frames), f"{name}: {len(la)} vs {len(lb)} rows"
            assert la[:CKPT_AT] == lb[:CKPT_AT], f"{name}: rows before the checkpoint changed"
            ta = load_kitti_trajectory(os.path.join(dir_a, name))
            tb = load_kitti_trajectory(os.path.join(dir_b, name))
            worst = max(worst, float(np.abs(ta - tb).max()))
            tc = load_kitti_trajectory(os.path.join(dir_c, name))
            spread = max(spread, float(np.abs(ta - tc).max()))
    d_final = float(np.abs(final_a[4:] - final_b[4:]).max())
    assert worst <= RESUME_TOL and d_final <= RESUME_TOL, \
        f"resumed run differs: rows {worst}, final MO position {d_final} (tolerance {RESUME_TOL})"
    print(f"  checkpoint {size / 2**20:.0f} MiB; rows 0..{CKPT_AT - 1} byte-identical; rows "
          f"{CKPT_AT}..{len(frames) - 1} within {worst:.2e} and the final MO position within "
          f"{d_final:.2e} m of the uninterrupted run (tolerance {RESUME_TOL}: float atomics; two "
          f"uninterrupted runs differ by {spread:.2e}); "
          f"uninterrupted run with 2 checkpoints {t_run:.1f} s [{card}]")
    fresh_device(torch.device("cuda", 0))


def check_cli(card):
    """Phase 8b: ``python -m vloam_tpu_torch.runtime`` in a subprocess, on
    its default device."""
    cmd = [sys.executable, "-m", "vloam_tpu_torch.runtime", "--dataset", "synthetic",
           "--frames", "4", "--json"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    assert res.returncode == 0, f"CLI exited {res.returncode}:\n{res.stderr[-3000:]}"
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, f"CLI printed {len(lines)} lines, want one JSON line:\n{res.stdout}"
    out = json.loads(lines[0])
    assert out["frames"] == 4 and np.isfinite(out["final_err_mo_m"]), out
    assert out["final_err_mo_m"] / out["path_len_m"] <= DRIFT_TOL, out
    print(f"  {' '.join(cmd[1:])}: exit 0 in {time.perf_counter() - t0:.1f} s, one JSON line: "
          f"{lines[0]} [{card}]")


if __name__ == "__main__":
    sys.exit(main())
