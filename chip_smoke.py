#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its frame step on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. the card (name and power limit from nvidia-smi), torch/CUDA versions,
   nvcc, and whether triton imports;
2. the kernel build from ``vloam_tpu_torch/csrc`` (one nvcc per source, all
   at once) and its seconds, and the stream handle the wrappers launch on
   (``kernels.stream_ptr``) against PyTorch's current stream, outside and
   inside a graph capture;
3. each kernel against its plain PyTorch version on the card, on the
   arguments the frame step passes it (captured from a warm-up drive of the
   full step): the k-NN pair and lidar GN at LO's and MO's call shapes (the
   k-NN bit for bit, d2 and idx; MO's with the mapping step's search radius
   and without it, with the share of tile steps the radius skips, at frame
   15 and again at frame 35, after the submap cache has been rebuilt in Morton
   order), the k-NN
   problems of ``tools.knn_check.cases`` made to break a kernel that splits
   and merges, the
   single-problem k-NN on each group of the MO call (also against the pair
   kernel, bit for bit; ``nn1``; one k outside the register instantiations)
   and the map association built on it, the VO GN solve on a tracked frame,
   the KLT patch gather at the two coarse pyramid levels of frame 1 and
   at level 0 of a tracked frame, and its single-image and stacked launch
   forms at the ORB frontend's shape and at a BRISK blur stack's; with the
   tolerances below, the median times of both (CUDA events, 20 runs), for
   the k-NN and Gauss-Newton kernels, the KLT gather at level 0 and the
   gather's two other forms (and their index-call library) the device time
   per call when 20 calls are captured in one CUDA graph and replayed, with
   its share of the kernel's roofline bound, and each kernel's bound (a
   gather's counts the image floats its windows read, once, and the share of
   the images they cover at the KLT's level-0 call).
   Then (3b) the single-problem map association path, driven with the
   launch counts at 0: MO's two outer iterations with one k-NN launch per
   feature type, against the fused path from the same pose;
   and (3c) the patch-gather measurement tool
   (``vloam_tpu_torch.tools.gather_experiments``) in process, with the
   launch counts at 0: its eleven kernels, the shipped two-image kernel, its
   single-image and stacked forms and the plain gather, each equal to its
   plain version and timed (G7's and G8's bounds from the image floats their
   windows read), then the four exact gathers, G7 and G8 on four inputs
   made to break them (one bucket, every alignment and edge, magnitudes
   1e-30 to 1e30, 37 keypoints in two bands of each image; G8 on whole
   blocks of 32), G7 and G8 on images of NaN, -0.0, subnormals and
   infinities, the five sweeps on negative images with planted maxima and
   with a NaN (held with a NaN-aware equality: the NaN masks, then every
   other value bit for bit), and G5 with its maximum at each end of what
   each block of its cluster reads, one call each;
4. the lidar slice (scan registration -> LO -> MO) alone, 12 frames;
5. the full step ``vloam_step`` in the decoupled (D) mode at full
   ``kitti_hdl64`` width with the whole map on the device: 40 frames of
   the ``bench._gen_frames`` course (synthetic HDL-64 scans of ~100k points
   and 376x1248 blob images along a gently turning street, crossing the
   x = 25 m cube boundary near frame 32), checked against ground truth, the
   kernels' launch counts and the slice's count of synchronising calls;
6. the coupled (C) mode, 12 frames of the same course;
7. the runtime entry point: first the native host library
   (``runtime/native``, ``native/vloam_host.cpp`` built by g++: its path
   and seconds, or why this machine cannot build it; a failed build where
   g++ and libpng are present fails the run), its depth buckets and
   less-flat table against the NumPy ones on phase 2's 40 grids (equal
   within tests/test_native.py's tolerances, host ms a call each way);
   then ``runtime.driver.run_synthetic`` over 40 full frames (raw clouds
   and images in, three KITTI trajectory files out, the host stages in the
   library), checked against ground truth, phase 5's launch counts, and
   the count of synchronising calls of a steady frame; VloamDriver's stage
   times; (7b) ``run_kitti`` on phase 2's first 12 frames written as a
   KITTI raw drive (.bin files, zlib-written PNGs, calibration files),
   through the native prefetcher and through the NumPy loaders, the
   exported rows within 5e-3 of each other;
8. checkpoint and resume (12 frames, a checkpoint at 6, a fresh driver
   resumed from it) and the CLI in a subprocess, in KLT mode and with
   ``--descriptor-match``;
9. the full step in (D) with VO in descriptor-match mode
   (``optical_flow_match=False``, ORB descriptors on the single-image patch
   gather, brute-force Hamming matching), 12 frames;
10. the ``close()`` epilogue: the ring course of
   tests/test_driver_loop_closure.py (56 frames, one lap) through
   ``VloamDriver(loop_closure=True, ...).process`` at full ``kitti_hdl64``
   width, then ``close()``: keyframe features, revisit detection, the
   seed-batched registration (B1 and the batched B3, one launch each per
   outer iteration) and the banded pose-graph solve, with the ms of each
   stage per loop pair behind a device sync, the launches per pair, the
   arbiter's single-problem k-NN (every seed's sample stacked as its
   queries) bit-equal to its plain version on the inputs it was given, and
   the raw and refined trajectories against ground truth;
11. the full step on the raw padded clouds of phase 2's first 12 frames
   (``pre_gridded=False``, ``pre_buckets=None``: ring gridding, depth
   buckets and the less-flat reduction on the device) against the
   pre-gridded step given the host-built grid and buckets of the same
   clouds: the same launches a frame as phase 5, no more synchronising
   calls, final LO/MO/VO positions within 5 mm, ms/frame of both;
12. the validation drive (``tools.validate_drive.drive``): 60 snake frames
   at full width made once, in (D) without and with
   ``exclude_unreliable``, MO final error within 3 % of the path in both,
   ATE, the KITTI segment error where the drive has segments, steady
   ms/frame.

Phase 3 also holds the batched B3 (``solve_pose_gn_lidar_batched``, seven
seeds of frame 15's LO solve) to its plain version, its batch of one to the
unbatched wrapper's launch (the same entry, batch strides 0) bit for bit,
and the k-NN pair on seven seeds' stacked queries to seven unbatched calls
row by row.

Then the device kernels one Gauss-Newton wrapper call (the batched one
included), and one call of B2's pair, single-image and stacked forms, G1-G5
and G7-G11, runs (torch.profiler, after every timed phase: once it has run,
launches cost more on the host),
one JSON line of per-kernel results, the card's name and power limit, and
last the line ``{"ok": true, "device": {...}}``.  Any failure raises
and exits nonzero before that line; so does a machine without CUDA.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import warnings
import zlib
from unittest import mock

import numpy as np
import torch

N_FRAMES = 40          # full step (D), phase 5
N_SHORT = 12           # lidar slice (phase 4) and coupled mode (phase 6)
N_WARMUP = 36          # frames of the warm-up drive whose calls feed phase 3
KERNEL_FRAME = 15      # the steady frame whose calls phase 3 checks and times
REBUILT_FRAME = 35     # a frame after the course crossed a cube boundary (near frame 32): MO's
                       # submap cache has been rebuilt, in Morton order, from the filled map
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

MIN_ORB_MATCHES = 100  # valid matches a frame in descriptor mode (tests/test_orb.py:56)
N_SEEDS = 7            # loop closure's seeds: the chain estimate and 6 coarse peaks
VALIDATION_FRAMES = 60  # the validation drive of phase 12 (tools/validate_drive runs 300)
# the ring course of tests/test_driver_loop_closure.py (phase 10)
RING_FRAMES, RING_SPEED = 56, 1.1
RING_KW = dict(keyframe_every=5, loop_radius=6.0, loop_min_travel=25.0, loop_drift_rate=0.02,
               loop_min_gap=3)
BRISK_BLUR_SIGMAS = (0.8, 1.8, 3.2)   # the blur stack of one BRISK octave (ops/brisk.py:41)

KERNELS = {   # name: (source under vloam_tpu_torch/csrc, the TPU kernel it replaces)
    "knn_pair": ("knn_pair.cu", "vloam_tpu/ops/pallas_knn.py:124"),
    "knn": ("knn.cu", "vloam_tpu/ops/pallas_knn.py:53"),
    "gn_lidar": ("gn_lidar.cu", "vloam_tpu/ops/pallas_gn.py:138"),
    "gn_vo": ("gn_vo.cu", "vloam_tpu/ops/pallas_gn.py:208"),
    # the same TPU kernel under jax.vmap over loop closure's seeds
    # (vloam_tpu/parallel/loop_closure.py:299-311): a problem axis on its grid
    "gn_lidar_batched": ("gn_lidar.cu", "vloam_tpu/ops/pallas_gn.py:138"),
    "gather_patches": ("gather_patches.cu", "vloam_tpu/ops/pallas_gather.py:57"),
    "strip_sweep": ("gather_sweeps.cu", "tools/gather_experiments.py:107"),
    "strip_sweep_db": ("gather_sweeps.cu", "tools/gather_experiments.py:143"),
    "strip_sweep_batched": ("gather_sweeps.cu", "tools/gather_experiments.py:188"),
    "strip_sweep_flat": ("gather_sweeps.cu", "tools/gather_experiments.py:229"),
    "whole_image": ("gather_sweeps.cu", "tools/gather_experiments.py:270"),
    "gather_narrow": ("gather_variants.cu", "tools/gather_experiments.py:304"),
    "dma_only": ("gather_variants.cu", "tools/gather_experiments.py:389"),
    "compact_only": ("gather_variants.cu", "tools/gather_experiments.py:439"),
    "gather_resident": ("gather_variants.cu", "tools/gather_experiments.py:497"),
    "gather_mma": ("gather_variants.cu", "tools/gather_experiments.py:546"),
    "gather_resident_mma": ("gather_variants.cu", "tools/gather_experiments.py:612"),
}
# the other two launch forms of the gather_patches kernel, listed under its entry
GATHER_FORMS = ("gather_patches_single", "gather_patches_stack")


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
    check_stream_ptr(dev, card)

    cfg = kitti_hdl64()
    ext = fg.kitti_default_extrinsics(dev)
    t0 = time.perf_counter()
    raw, poses = stream.gen_raw(cfg, ext, N_FRAMES, speed=SPEED, yaw_rate=YAW_RATE)
    proj = stream.camera_matrices(ext)[1]
    frames = [stream.host_frame(cfg, proj, img, cloud) for img, cloud in raw]   # = gen_frames'
    raw = raw[:N_SHORT]        # the raw clouds of the prefetcher phase and phase 11
    n_pts = [int(f[2].sum()) for f in frames]
    print(f"host data: {N_FRAMES} frames, {int(np.mean(n_pts))} gridded points/scan on average, "
          f"376x1248 images, {time.perf_counter() - t0:.1f} s (not timed below)")
    dframes = [frame_to_device(*f, dev) for f in frames]

    results, calls = check_kernels(cfg, ext, dframes, card)
    launches = {"knn": check_single_association(cfg, calls, card)}
    gn_sites = {site: calls[(KERNEL_FRAME, kind, site)][0][0]
                for site, kind in (("LO", "gn"), ("MO", "gn"), ("VO", "gn_vo"))}
    gn_sites["LO batched"] = batched_gn_args(gn_sites["LO"])
    del calls
    launches["gather_patches_stack"] = check_stack_path(cfg, dframes[KERNEL_FRAME][0], card)
    launches.update(check_variants(results, card))
    slice_syncs = check_slice(cfg, dframes[:N_SHORT], poses, card)
    step_launches, per_frame, step_syncs = check_step(cfg, ext, dframes, poses, card, slice_syncs)
    launches.update(step_launches)
    check_coupled(cfg, ext, dframes[:N_SHORT], poses, card)
    del dframes
    host_lib = check_driver(cfg, frames, card, per_frame, step_syncs)
    check_prefetcher(cfg, ext, raw, host_lib, card)
    check_resume(cfg, ext, frames[:N_RESUME], card)
    check_cli(card)
    check_cli(card, "--descriptor-match")
    dframes = [frame_to_device(*f, dev) for f in frames[:N_SHORT]]
    launches["gather_patches_single"] = check_descriptor_mode(cfg, ext, dframes, poses, card,
                                                              step_syncs)
    del dframes
    launches["gn_lidar_batched"] = check_close(cfg, card)
    check_raw_input(cfg, ext, raw, poses, card, per_frame, step_syncs)
    del frames, raw
    check_validation_drive(cfg, ext, card)
    count_gn_kernels(gn_sites, card)
    count_gather_kernels(card)

    def entry(name, **kw):
        assert launches[name] > 0, f"{name}: not launched on its path"
        r = results[name]
        return {"name": name, "route": "cuda", **kw, "launches": launches[name],
                "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": max(r["ops_ms"], r["bytes_ms"]),
                "bound_by": "operations" if r["ops_ms"] >= r["bytes_ms"] else "bytes",
                "library_ms": r["library_ms"],
                **{k: r[k] for k in ("device_ms", "library_device_ms") if k in r}}

    kern = [entry(name, source=f"vloam_tpu_torch/csrc/{src}", replaces=rep)
            for name, (src, rep) in KERNELS.items()]
    forms = [entry(name) for name in GATHER_FORMS]
    # the stacked form's launches are those of check_stack_path's one call, not of a system path
    forms[1]["caller"] = "none in the port yet (the BRISK/FREAK descriptor support): driven alone"
    next(k for k in kern if k["name"] == "gather_patches")["forms"] = forms
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
        gather = laser_mapping._gather_submap

        def rebuild(*args, **kw):   # the frames on which MO rebuilt its submap cache
            calls["rebuilds"].append(frame[0])
            return gather(*args, **kw)

        stack.enter_context(mock.patch.object(laser_mapping, "_gather_submap", rebuild))
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
    "bytes_ms", "library_ms"}}, the captured calls).  Times add up over the
    call shapes timed for a kernel, and so do the two roofline times
    (operations over PEAK_F32, bytes over PEAK_BW) of the same calls.
    ``library_ms`` is the time of the one PyTorch call that computes the same
    function on the same inputs, None where there is none."""
    from vloam_tpu_torch.models.vloam import init_vloam_state
    from vloam_tpu_torch.ops import fused_knn, knn, patch_gather
    from vloam_tpu_torch.tools import knn_check
    from vloam_tpu_torch.tools.gather_experiments import graph_ms, patch_bytes, window_floats

    last = KERNEL_FRAME
    print(f"== phase 3: kernels vs plain PyTorch versions, at the frame step's call shapes "
          f"(a {N_WARMUP}-frame warm-up drive of the full step; frames 1, {last} and "
          f"{REBUILT_FRAME}) [{card}]")
    state, calls = capture_calls(init_vloam_state(cfg, dframes[0][0].device), dframes[:N_WARMUP],
                                 ext, cfg, keep={1, last, REBUILT_FRAME})
    del state
    results = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
                   "library_ms": None} for k in (*KERNELS, *GATHER_FORMS)}

    def timed(name, label, kernel, plain, ops, nbytes, library=None, graph=False):
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        ops_ms, bytes_ms = ops / PEAK_F32 * 1e3, nbytes / PEAK_BW * 1e3
        r = results[name]
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["ops_ms"] += ops_ms
        r["bytes_ms"] += bytes_ms
        device = ""
        if graph:   # the wrapper's device work alone: no Python and no launch path
            device_ms = graph_ms(kernel)
            r["device_ms"] = r.get("device_ms", 0.0) + device_ms
            bound = max(ops_ms, bytes_ms)
            device = (f" ({device_ms:.5f} ms a call inside a replayed CUDA graph of 20 calls, "
                      f"{bound / device_ms:.1%} of its bound)")
        print(f"  {name} {label}: kernel {ms:.4f} ms{device}, plain {plain_ms:.4f} ms "
              f"(median of {TIMING_RUNS}); bound {max(ops_ms, bytes_ms):.5f} ms "
              f"({ops / 1e6:.2f} MFLOP -> {ops_ms:.5f} ms, {nbytes / 1e6:.3f} MB -> "
              f"{bytes_ms:.5f} ms) [{card}]")
        if library is not None:
            r["library_ms"] = time_ms(library)
            lib_device = ""
            if graph:
                r["library_device_ms"] = graph_ms(library)
                lib_device = f" ({r['library_device_ms']:.4f} ms a call inside a replayed graph)"
            print(f"  {name} {label}: the one PyTorch call for the same function "
                  f"{r['library_ms']:.4f} ms{lib_device} [{card}]")
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
        radius = kw.get("prune_radius", (None, None))
        assert (site == "MO") == (radius[0] is not None and radius[1] is not None), \
            f"{site}: prune_radius {radius}"
        got = fused_knn.knn_pair(*args, **kw)
        ref = fused_knn.knn_pair_reference(*args, **kw)
        torch.cuda.synchronize()
        work = []
        for g_, r_, q, c, m, k, cnt, r in ((got[0], ref[0], qa, ca, ma, ka, ac, radius[0]),
                                           (got[1], ref[1], qb, cb, mb, kb, bc, radius[1])):
            shape = f"{site} {q.shape[0]}x{c.shape[0]} k={k}" + (f" r={r:.3f}" if r else "")
            results["knn_pair"]["err"] = max(results["knn_pair"]["err"],
                                             knn_compare(f"knn_pair {shape}", g_, r_))
            knn_check.assert_bit_equal(f"knn_pair {shape}", g_, r_)
            work.append(knn_work(q, c, m, k, *cnt))
            cdist_topk(shape, q, c, k)
        pair_ms[site] = timed("knn_pair", f"{site} pair", lambda: fused_knn.knn_pair(*args, **kw),
                              lambda: fused_knn.knn_pair_reference(*args, **kw),
                              work[0][0] + work[1][0], work[0][1] + work[1][1], graph=True)
        share, steps = knn_check.skipped_share(args, kw)
        blocks = [knn.knn_plan(q.shape[0], c.shape[0], pruned=r is not None)[0]
                  * -(-q.shape[0] // knn.TILE_Q) for q, c, r in ((qa, ca, radius[0]),
                                                                 (qb, cb, radius[1]))]
        assert sum(blocks) >= torch.cuda.get_device_properties(0).multi_processor_count
        print(f"  knn_pair {site} pair: bit-equal to the plain version (d2 and idx); sweep blocks "
              f"{blocks[0]} + {blocks[1]}; (query tile, candidate tile) steps swept / skipped "
              f"{steps[0]} / {steps[1]} and {steps[2]} / {steps[3]}: {share * 100:.1f} % skipped")
        if site == "MO":
            # the same call without the radius: the rule is the unpruned result clamped
            free_kw = {k: v for k, v in kw.items() if k != "prune_radius"}
            free = fused_knn.knn_pair(*args, **free_kw)
            for g_, f_, r, name in ((got[0], free[0], radius[0], "corner"),
                                    (got[1], free[1], radius[1], "surf")):
                knn_check.assert_bit_equal(f"knn_pair MO {name}, pruned vs clamped unpruned",
                                           g_, knn.clamp_radius(*f_, r))
                inside = f_[0] <= knn.radius_sq(r)
                print(f"  knn_pair MO {name}: equal to the unpruned launch in the "
                      f"{int(inside.sum())} of {inside.numel()} slots with d2 <= r^2, +inf / 0 in "
                      f"the others")
            ms = time_ms(lambda: fused_knn.knn_pair(*args, **free_kw))
            dev_ms = graph_ms(lambda: fused_knn.knn_pair(*args, **free_kw))
            print(f"  knn_pair MO pair without the radius: kernel {ms:.4f} ms ({dev_ms:.4f} ms a "
                  f"call inside a replayed CUDA graph) [{card}]")

    # MO's call once the cache has been rebuilt in Morton order: what the radius skips then
    args, kw = calls[(REBUILT_FRAME, "knn", "MO")][0]
    rebuilds = calls["rebuilds"]
    assert any(0 < f <= REBUILT_FRAME for f in rebuilds), \
        f"no cache rebuild after frame 0: {rebuilds}"
    got = fused_knn.knn_pair(*args, **kw)
    ref = fused_knn.knn_pair_reference(*args, **kw)
    for grp, name in enumerate(("corner", "surf")):
        knn_check.assert_bit_equal(f"knn_pair MO {name}, frame {REBUILT_FRAME}", got[grp], ref[grp])
    share, steps = knn_check.skipped_share(args, kw)
    free_kw = {k: v for k, v in kw.items() if k != "prune_radius"}
    times = [f(lambda: fused_knn.knn_pair(*args, **k_)) for k_ in (kw, free_kw)
             for f in (time_ms, graph_ms)]
    print(f"  knn_pair MO pair at frame {REBUILT_FRAME} (cache rebuilt on frames {rebuilds}; live "
          f"{int(kw['a_counts'][0])} / {int(kw['b_counts'][0])} queries, "
          f"{int(kw['a_counts'][1])} / {int(kw['b_counts'][1])} candidates): bit-equal to the plain version; steps swept / "
          f"skipped {steps[0]} / {steps[1]} and {steps[2]} / {steps[3]}: {share * 100:.1f} % "
          f"skipped; kernel {times[0]:.4f} ms ({times[1]:.4f} ms inside a replayed CUDA graph), "
          f"without the radius {times[2]:.4f} ms ({times[3]:.4f} ms) [{card}]")

    for case in knn_check.cases():
        knn_check.check_case(case, qa.device)
        print(f"  knn_pair / knn, {case['name']}: bit-equal to the plain version (d2 and idx)")

    # the single-problem kernel on each group of the MO call
    args, kw = calls[(last, "knn", "MO")][0]
    qa, ca, ma, ka, qb, cb, mb, kb = args
    pair = fused_knn.knn_pair(*args, a_counts=kw["a_counts"], b_counts=kw["b_counts"])
    single_ms = 0.0
    for grp, (q, c, m, k, cnt) in enumerate(((qa, ca, ma, ka, kw["a_counts"]),
                                             (qb, cb, mb, kb, kw["b_counts"]))):
        shape = f"MO {q.shape[0]}x{c.shape[0]} k={k}"
        one = lambda: knn.knn(q, c, m, k, cand_count=cnt[1], query_count=cnt[0])  # noqa: E731
        ref = lambda: knn.knn_reference(q, c, m, k, cand_count=cnt[1], query_count=cnt[0])  # noqa: E731
        got = one()
        torch.cuda.synchronize()
        want = ref()
        results["knn"]["err"] = max(results["knn"]["err"], knn_compare(f"knn {shape}", got, want))
        knn_check.assert_bit_equal(f"knn {shape}", got, want)
        assert torch.equal(got[0], pair[grp][0]) and torch.equal(got[1], pair[grp][1]), \
            f"knn {shape}: differs from the same group of one knn_pair launch"
        d1, i1 = knn.nn1(q, c, m, cand_count=cnt[1], query_count=cnt[0])
        assert torch.equal(d1, got[0][:, 0]) and torch.equal(i1, got[1][:, 0]), \
            f"nn1 {shape}: differs from column 0 of k={k}"
        print(f"  knn {shape}: bit-equal to its knn_pair group (no radius); nn1 equals column 0")
        single_ms += timed("knn", shape, one, ref, *knn_work(q, c, m, k, cnt[0], cnt[1]),
                           graph=True)
    print(f"  knn, both MO groups one after the other {single_ms:.4f} ms; the same two problems in "
          f"one knn_pair launch with the radius {pair_ms['MO']:.4f} ms [{card}]")
    q, c, m = qb[:1024].contiguous(), cb[:8192].contiguous(), mb[:8192].contiguous()
    got, want = knn.knn(q, c, m, 32), knn.knn_reference(q, c, m, 32)
    results["knn"]["err"] = max(results["knn"]["err"], knn_compare(
        "knn 1024x8192 k=32 (run-time k)", got, want))
    knn_check.assert_bit_equal("knn 1024x8192 k=32 (run-time k)", got, want)

    gn_args, _ = calls[(last, "gn", "MO")][0]
    check_correspondences(cfg, args, kw, gn_args)

    check_gn(calls, timed, results, card)
    check_batched(calls, timed, results, card)

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
            results["gather_patches"]["err"] = max(results["gather_patches"]["err"],
                                                   float((g_ - r_).abs().max()))
            assert torch.equal(g_, r_), f"gather_patches {label}: kernel differs from plain"
        img = args[0]
        print(f"  gather_patches {label} {tuple(img.shape)} -> 2x{tuple(got[0].shape)}: "
              f"bit-equal to the plain version")
        if label.endswith("level 0"):
            # a pure copy: the floats under each image's windows and the corners read
            # once, both patch stacks written once
            nbytes = patch_bytes(args[0].shape, args[2]) + patch_bytes(args[1].shape, args[3])
            under = sum(window_floats((1, *im.shape), np.zeros(c.shape[0], np.int64),
                                      *c.cpu().numpy().astype(np.int64).T[::-1])
                        for im, c in ((args[0], args[2]), (args[1], args[3])))
            print(f"  gather_patches {label}: its windows read {under} of the two images' "
                  f"{2 * img.numel()} floats ({under / (2 * img.numel()):.1%}); bound bytes "
                  f"{nbytes / 1e6:.3f} MB, the two whole images counted once "
                  f"{(nbytes + 4 * (2 * img.numel() - under)) / 1e6:.3f} MB")
            timed("gather_patches", f"{label} {tuple(img.shape)} N={got[0].shape[0]}",
                  lambda: patch_gather.gather_patches_pair(*args),
                  lambda: patch_gather.gather_patches_pair_reference(*args), 0, nbytes,
                  graph=True)
    check_gather_forms(cfg, dframes[last][0], timed, results)
    print("  library_ms is null for the k-NN and Gauss-Newton kernels and the two-image gather: "
          "no single PyTorch call computes a masked k-NN with dynamic counts, a fused "
          "Gauss-Newton solve, or windows of two separate images")
    return results, calls


def check_gn(calls, timed, results, card):
    """Phase 3, the Gauss-Newton kernels B3 and B4 (``tools/gn_check``):
    every solve of frames 1, 15 and 35 and the problems of ``gn_check.cases``
    against the plain version within ``gn_check``'s tolerance; at frame 15's
    first LO, MO and VO solve the wrapper's time and the plain version's, the
    wrapper's, the launch alone's and the chain floor's device time inside a
    replayed CUDA graph (the device kernels of a call are counted last,
    ``count_gn_kernels``)."""
    from vloam_tpu_torch.tools import gn_check

    last = KERNEL_FRAME
    for frame in (1, last, REBUILT_FRAME):
        for site, kind, name in (("LO", "gn", "lidar"), ("MO", "gn", "lidar"),
                                 ("VO", "gn_vo", "vo")):
            for n, (args, _) in enumerate(calls[(frame, kind, site)]):
                err = gn_check.check(f"frame {frame} {site} solve {n}", name, args)
                results[f"gn_{name}"]["err"] = max(results[f"gn_{name}"]["err"], err)
    lidar_args, vo_args = calls[(last, "gn", "MO")][0][0], calls[(last, "gn_vo", "VO")][0][0]
    for label, name, args, pose in gn_check.cases(lidar_args, vo_args):
        err = gn_check.check(f"MO/VO of frame {last}, {label}", name, args, pose)
        results[f"gn_{name}"]["err"] = max(results[f"gn_{name}"]["err"], err)

    for site in ("LO", "MO", "VO"):
        if site == "VO":
            kind, args = "vo", vo_args
            n32, n22, m, iters = int(args[4].sum()), int(args[5].sum()), args[1].shape[0], args[6]
            label = f"VO M={m} (3D-2D {n32}, 2D-2D {n22}), {iters} iterations"
            # a match: X0 12 bytes, xb0 and xb1 8 each, two mask bytes; the pose in and out
            ops, nbytes = GN_VO_OPS * (n32 + n22) * iters, 30 * m + 56
        else:
            kind, args = "lidar", calls[(last, "gn", site)][0][0]
            (_, _, _, v_e), (_, _, _, v_s), iters = args[1], args[2], args[3]
            be, bs, live = v_e.shape[0], v_s.shape[0], int(v_e.sum()) + int(v_s.sum())
            label = f"{site} Be={be} Bs={bs} ({live} live)"
            # an edge: p, a, b 36 bytes and its mask byte; a plane: p, n, d 28 and its
            # mask byte; the pose in and out 28 bytes each
            ops, nbytes = GN_LIDAR_OPS * live * iters, 37 * be + 29 * bs + 56
        kernel, plain = gn_check.SOLVES[kind]
        timed(f"gn_{kind}", label, lambda: kernel(*args), lambda: plain(*args), ops, nbytes,
              graph=True)
        print(f"  {gn_check.launch_line(f'gn_{kind} {label}', kind, args, card)}")


def seed_poses(n, dev, scale=1.0):
    """n small SE(3) perturbations (the first the identity), from a seed."""
    from vloam_tpu_torch import geometry as geo

    rng = np.random.default_rng(5)
    aa = rng.normal(0, 0.02 * scale, (n, 3)).astype(np.float32)
    t = rng.normal(0, 0.2 * scale, (n, 3)).astype(np.float32)
    aa[0], t[0] = 0.0, 0.0
    q = geo.angle_axis_to_quat(torch.tensor(aa))
    return geo.pose_from_qt(q, torch.tensor(t)).to(dev)


def batched_gn_args(lo_args, n=N_SEEDS):
    """Frame 15's LO solve under ``n`` seeds, laid out as solve_f2f_batched
    lays them out: pose0 moved by each seed, the feature points one view for
    all (batch stride 0), the other rows stacked."""
    from vloam_tpu_torch import geometry as geo

    pose0, edge, plane, *rest = lo_args
    poses = geo.pose_compose(seed_poses(n, pose0.device), pose0[None].expand(n, -1))
    stack = lambda x: torch.stack([x] * n)  # noqa: E731
    return (poses.contiguous(), (edge[0].expand(n, -1, -1), *map(stack, edge[1:])),
            (plane[0].expand(n, -1, -1), *map(stack, plane[1:])), *rest)


def check_batched(calls, timed, results, card):
    """Phase 3, the batched B3 and the stacked B1 of loop closure's
    registration, at the loop path's shapes (S = 7 seeds of frame 15's LO
    problems: Be = 768, Bs = 1536; queries 7 x 768 and 7 x 1536)."""
    from vloam_tpu_torch import geometry as geo
    from vloam_tpu_torch.ops import fused_gn, fused_knn, knn
    from vloam_tpu_torch.tools import gn_check, knn_check
    from vloam_tpu_torch.tools.gather_experiments import graph_ms

    last = KERNEL_FRAME
    lo_args = calls[(last, "gn", "LO")][0][0]
    args = batched_gn_args(lo_args)
    poses, edge, plane, iters, delta, lam = args
    S, be, bs = poses.shape[0], edge[0].shape[1], plane[0].shape[1]
    got = fused_gn.solve_pose_gn_lidar_batched(*args)
    ref = fused_gn.solve_pose_gn_lidar_batched_reference(*args)
    torch.cuda.synchronize()
    err, equal = 0.0, 0
    for k in range(S):
        err = max(err, gn_check._close(f"gn_lidar_batched seed {k}", got[k], ref[k],
                                       "the plain version"))
        one = fused_gn.solve_pose_gn_lidar(poses[k], tuple(x[k] for x in edge),
                                           tuple(x[k] for x in plane), iters, delta, lam)
        equal += int(torch.equal(one, got[k]))
    results["gn_lidar_batched"]["err"] = err
    single = fused_gn.solve_pose_gn_lidar_batched(poses[:1], tuple(x[:1] for x in edge),
                                                  tuple(x[:1] for x in plane), iters, delta, lam)
    unbatched = fused_gn.solve_pose_gn_lidar(poses[0], *lo_args[1:])
    assert torch.equal(single[0], unbatched), \
        f"gn_lidar_batched: batch of one {single[0]} differs from the unbatched launch {unbatched}"
    print(f"  gn_lidar_batched S={S} Be={be} Bs={bs}: within the plain version's bound on every "
          f"seed; batch of one bit-equal to the unbatched launch; {equal} of {S} seeds bit-equal "
          f"to an unbatched launch each")
    live = int(edge[3].sum()) + int(plane[3].sum())
    # each input read once: the shared feature points once, the rest per seed
    nbytes = 12 * be + 12 * bs + S * (25 * be + 17 * bs + 56)
    timed("gn_lidar_batched", f"S={S} Be={be} Bs={bs} ({live} live)",
          lambda: fused_gn.solve_pose_gn_lidar_batched(*args),
          lambda: fused_gn.solve_pose_gn_lidar_batched_reference(*args),
          GN_LIDAR_OPS * live * iters, nbytes, graph=True)
    one_ms = graph_ms(lambda: fused_gn.solve_pose_gn_lidar(*lo_args))
    print(f"  gn_lidar_batched: {results['gn_lidar_batched']['device_ms']:.4f} ms a batched call "
          f"inside a replayed CUDA graph; the unbatched LO call {one_ms:.4f} ms, {S} of them "
          f"{S * one_ms:.4f} ms [{card}]")

    # the k-NN pair on the seeds' stacked queries, against one call a seed
    kargs, kw = calls[(last, "knn", "LO")][0]
    qa, ca, ma, ka, qb, cb, mb, kb = kargs
    seeds = seed_poses(S, qa.device)
    qas = [geo.pose_apply(seeds[k], qa) for k in range(S)]
    qbs = [geo.pose_apply(seeds[k], qb) for k in range(S)]
    sa, sb = torch.cat(qas), torch.cat(qbs)
    stacked = fused_knn.knn_pair(sa, ca, ma, ka, sb, cb, mb, kb, **kw)
    ref = fused_knn.knn_pair_reference(sa, ca, ma, ka, sb, cb, mb, kb, **kw)
    for grp in range(2):
        knn_check.assert_bit_equal(f"knn_pair stacked group {grp}", stacked[grp], ref[grp])
    for k in range(S):
        one = fused_knn.knn_pair(qas[k], ca, ma, ka, qbs[k], cb, mb, kb, **kw)
        for grp, m in ((0, qa.shape[0]), (1, qb.shape[0])):
            rows = slice(k * m, (k + 1) * m)
            assert torch.equal(stacked[grp][0][rows], one[grp][0]) and \
                torch.equal(stacked[grp][1][rows], one[grp][1]), \
                f"knn_pair stacked: seed {k} group {grp} differs from its unbatched call"
    plans = [knn.knn_plan(q.shape[0], c.shape[0]) for q, c in ((sa, ca), (sb, cb))]
    st_ms = graph_ms(lambda: fused_knn.knn_pair(sa, ca, ma, ka, sb, cb, mb, kb, **kw))
    one_ms = graph_ms(lambda: fused_knn.knn_pair(qa, ca, ma, ka, qb, cb, mb, kb, **kw))
    print(f"  knn_pair stacked {sa.shape[0]}x{ca.shape[0]} k={ka} + {sb.shape[0]}x{cb.shape[0]} "
          f"k={kb} (plans {plans}): bit-equal to the plain version and, row by row, to {S} "
          f"unbatched calls; {st_ms:.4f} ms a call inside a replayed CUDA graph, one seed's call "
          f"{one_ms:.4f} ms, {S} of them {S * one_ms:.4f} ms [{card}]")


def ring_scene(radius_course: float) -> np.ndarray:
    """Boxes and poles ringing a circular course centred at (0, r): the scene
    of tests/test_driver_loop_closure.py (a copy: that file imports jax)."""
    rng = np.random.default_rng(5)
    cx, cy = 0.0, radius_course
    boxes = []
    for i in range(16):
        a = i * 2 * np.pi / 16
        r = radius_course + 14.0 + rng.uniform(-2, 2)
        x, y = cx + r * np.cos(a), cy + r * np.sin(a)
        w, d, h = rng.uniform(4, 8), rng.uniform(4, 8), rng.uniform(5, 12)
        boxes.append([x, y, -1.7, x + w, y + d, -1.7 + h])
    for i in range(20):
        a = (i + 0.5) * 2 * np.pi / 20
        r = radius_course + 8.0 + rng.uniform(-1, 1)
        x, y = cx + r * np.cos(a), cy + r * np.sin(a)
        boxes.append([x, y, -1.7, x + 0.3, y + 0.3, 3.0])
    return np.array(boxes, np.float64)


def check_close(cfg, card):
    """Phase 10: the close() epilogue on the ring course, driven the way
    tests/test_driver_loop_closure.py drives it.  Returns the batched B3's
    launches in the run."""
    from vloam_tpu_torch.data import synthetic
    from vloam_tpu_torch.models.frame_graph import kitti_default_extrinsics
    from vloam_tpu_torch.ops import fused_gn, fused_knn, knn
    from vloam_tpu_torch.parallel import loop_closure as lc
    from vloam_tpu_torch.runtime import driver as drv

    n = RING_FRAMES
    yaw_rate = 2 * np.pi / n
    print(f"== phase 10: close() epilogue (pose graph + loop closure), ring course, kitti_hdl64, "
          f"{n} frames, n_azimuth=1800 [{card}]")
    poses = synthetic.straight_trajectory(n, speed=RING_SPEED, yaw_rate=yaw_rate)
    scene = ring_scene(RING_SPEED / yaw_rate)
    t0 = time.perf_counter()
    clouds = [synthetic.simulate_scan(R, t, scene, n_azimuth=1800, noise=0.01, seed=i)
              for i, (R, t) in enumerate(poses)]
    print(f"  host data: {n} scans, {int(np.mean([len(c) for c in clouds]))} points on average, "
          f"{time.perf_counter() - t0:.1f} s (not timed below)")
    fresh_device(torch.device("cuda", 0))
    stages = collections.defaultdict(list)
    pair_launches = []

    def timed_stage(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stages[name].append((time.perf_counter() - t) * 1e3)
            return out
        return run

    register = drv.register_loop

    def counted_register(*args, **kw):
        before = (fused_knn.LAUNCHES, fused_gn.LAUNCHES_BATCHED, knn.LAUNCHES)
        out = register(*args, **kw)
        pair_launches.append(tuple(a - b for a, b in zip(
            (fused_knn.LAUNCHES, fused_gn.LAUNCHES_BATCHED, knn.LAUNCHES), before)))
        return out

    arbiter_calls = []   # the arbiter's nn1 inputs: every seed's sample stacked

    def recorded_nn1(*args, **kw):
        arbiter_calls.append((args, kw))
        return knn.nn1(*args, **kw)

    fused_knn.LAUNCHES = fused_gn.LAUNCHES = fused_gn.LAUNCHES_BATCHED = knn.LAUNCHES = 0
    driver = drv.VloamDriver(cfg, kitti_default_extrinsics("cuda"), loop_closure=True, **RING_KW)
    frame_ms = []
    for cloud in clouds:
        t = time.perf_counter()
        driver.process(None, cloud)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
    assert fused_gn.LAUNCHES_BATCHED == 0
    with mock.patch.object(drv.VloamDriver, "_keyframe_features",
                           timed_stage("features", drv.VloamDriver._keyframe_features)), \
            mock.patch.object(lc, "coarse_align", timed_stage("coarse_align", lc.coarse_align)), \
            mock.patch.object(lc, "solve_f2f_batched",
                              timed_stage("registration", lc.solve_f2f_batched)), \
            mock.patch.object(lc, "tight_inlier_frac",
                              timed_stage("tight_inlier_frac", lc.tight_inlier_frac)), \
            mock.patch.object(lc, "nn1", recorded_nn1), \
            mock.patch.object(drv, "register_loop", counted_register), \
            mock.patch.object(drv, "optimize_pose_graph_banded",
                              timed_stage("pose_graph", drv.optimize_pose_graph_banded)):
        t = time.perf_counter()
        driver.close()
        close_s = time.perf_counter() - t
    batched = fused_gn.LAUNCHES_BATCHED
    check_arbiter_nn1(arbiter_calls, card)
    report = driver.refine_report
    gt = np.stack([t for _, t in poses])
    mo = np.stack([h[2] for h in driver._world_hist])
    refined = np.asarray(driver._refined, np.float64)
    assert refined.shape == (n, 7) and np.isfinite(refined).all()
    raw_ate = float(np.mean(np.linalg.norm(mo[:, 4:] - gt, axis=1)))
    ref_ate = float(np.mean(np.linalg.norm(refined[:, 4:] - gt, axis=1)))
    raw_end = float(np.linalg.norm(mo[-1, 4:] - gt[-1]))
    ref_end = float(np.linalg.norm(refined[-1, 4:] - gt[-1]))
    pairs = len(pair_launches)
    print(f"  {ms_line(frame_ms, 5, card)}")
    print(f"  keyframes {len(driver._keyframes)}; detections (registered pairs) {pairs}; accepted "
          f"loop factors {report['loop_factors']}; refine_report {report}")
    for name in ("features", "coarse_align", "registration", "tight_inlier_frac"):
        v = stages[name]
        per = sum(v) / max(pairs, 1)
        print(f"  {name}: {len(v)} calls, {sum(v):.3f} ms in all, {per:.3f} ms a pair "
              f"(host clock behind device syncs) [{card}]")
    print(f"  launches per registered pair (knn_pair, gn_lidar_batched, knn): {pair_launches}")
    pg = stages["pose_graph"]
    print(f"  pose-graph solves: {len(pg)}, {', '.join(f'{v:.1f}' for v in pg)} ms (banded, W={n}, "
          f"8 iterations) [{card}]")
    print(f"  close() {close_s:.3f} s [{card}]")
    print(f"  MO vs ground truth: ATE raw {raw_ate:.4f} m, refined {ref_ate:.4f} m; end error raw "
          f"{raw_end:.4f} m, refined {ref_end:.4f} m over {RING_SPEED * (n - 1):.1f} m")
    assert pairs >= 1 and all(p[:2] == (5, 5) for p in pair_launches), pair_launches
    assert batched == 5 * pairs, (batched, pairs)
    assert report["loop_factors"] >= 1, f"no loop factor accepted on the closed ring: {report}"
    assert ref_end <= raw_end, f"refined end error {ref_end} exceeds the raw one {raw_end}"
    del driver
    return batched


def check_arbiter_nn1(arbiter_calls, card):
    """B5 (``knn.nn1``) at the shape the arbiter gives it in phase 10, every
    seed's strided sample stacked as the queries: bit-equal to its plain
    version on each call's inputs (after the counts were read)."""
    from vloam_tpu_torch.ops import knn
    from vloam_tpu_torch.tools import knn_check

    assert arbiter_calls, "phase 10: the arbiter made no nn1 call"
    for i, ((q, c, m), kw) in enumerate(arbiter_calls):
        got = knn.nn1(q, c, m, **kw)
        want = knn.nn1_reference(q, c, m, **kw)
        knn_check.assert_bit_equal(f"nn1 arbiter call {i}", tuple(x[:, None] for x in got),
                                   tuple(x[:, None] for x in want))
    shapes = sorted({(q.shape[0], c.shape[0]) for (q, c, _), _ in arbiter_calls})
    plans = [knn.knn_plan(mq, nc) for mq, nc in shapes]
    print(f"  knn (nn1) in the arbiter: {len(arbiter_calls)} calls, queries x candidates "
          f"{shapes} (plans {plans}), each bit-equal to the plain version [{card}]")


def count_gn_kernels(sites, card):
    """The device kernels one GN wrapper call runs, by torch.profiler, on
    frame 15's first LO, MO and VO solves: one each, or "not measured" where
    the profiler shows no device event.  Run after every timed phase: once
    the profiler has run, every launch in the process costs more on the host
    (with it inside phase 3, phase 3c's launch-bound wrapper times rose
    1.5-2x and every frame median after it)."""
    from vloam_tpu_torch.tools import gn_check

    from vloam_tpu_torch.ops import fused_gn

    print(f"== device kernels per GN wrapper call (torch.profiler) [{card}]")
    for site, args in sites.items():
        if site == "LO batched":
            names = gn_check.device_kernels(lambda: fused_gn.solve_pose_gn_lidar_batched(*args))
            line = (f"gn_lidar_batched {site} S={args[0].shape[0]}: device kernels per wrapper "
                    f"call " + ("not measured (the profiler showed no device event)"
                                if names is None else f"{len(names)} ({names[0][:40]})")
                    + f" [{card}]")
        else:
            kind = "vo" if site == "VO" else "lidar"
            line, names = gn_check.kernels_line(f"gn_{kind} {site}", kind, args, card)
        print(f"  {line}")
        assert names is None or len(names) == 1, line


def orb_corners(img, cfg):
    """The smoothed image and the clipped int32 patch corners the ORB frontend
    gathers at (ops/orb.orb_descriptors), for the corners detected on ``img``."""
    from vloam_tpu_torch.ops import image_ops, orb

    pts, _, _ = image_ops.detect_corners(img, cfg.visual)
    H, W = img.shape
    corner = torch.round(pts).to(torch.int32) - orb.PATCH // 2
    corner = torch.stack([torch.clamp(corner[:, 0], 0, W - orb.PATCH),
                          torch.clamp(corner[:, 1], 0, H - orb.PATCH)], dim=-1).contiguous()
    return image_ops._sep_conv(img, orb._SMOOTH, orb._SMOOTH), corner


def blur_stack(img):
    """The (3, H, W) blur stack of BRISK's octave 0 (vloam_tpu/ops/brisk.py:263-270)."""
    from vloam_tpu_torch.ops import image_ops

    blurs = []
    for sig in BRISK_BLUR_SIGMAS:
        r = max(int(np.ceil(2.5 * sig)), 1)
        k1 = np.exp(-0.5 * (np.arange(-r, r + 1) / sig) ** 2)
        k1 = [float(v) for v in (k1 / k1.sum()).astype(np.float32)]
        blurs.append(image_ops._sep_conv(img, k1, k1))
    return torch.stack(blurs).contiguous()


def check_gather_forms(cfg, img, timed, results):
    """Phase 3, the single-image and stacked launch forms of the patch gather
    against their plain versions (equality), at the ORB frontend's shape and
    at a BRISK blur stack's.  The library call of each is one index call on
    the view of all the image's windows."""
    from vloam_tpu_torch.ops import patch_gather
    from vloam_tpu_torch.tools.gather_experiments import patch_bytes, window_view

    smooth, corner = orb_corners(img, cfg)
    n = corner.shape[0]
    cx, cy = corner[:, 0], corner[:, 1]
    got = patch_gather.gather_patches(smooth, corner)
    ref = patch_gather.gather_patches_reference(smooth, corner)
    windows = window_view(smooth)
    torch.cuda.synchronize()
    results["gather_patches_single"]["err"] = float((got - ref).abs().max())
    assert torch.equal(got, ref), "gather_patches (single image): kernel differs from plain"
    assert torch.equal(windows[cy, cx], ref), "single image: library call differs from plain"
    print(f"  gather_patches {tuple(smooth.shape)} N={n} -> {tuple(got.shape)}: bit-equal to the "
          f"plain version")
    # a pure copy: the floats under the windows and the corners read once, the
    # patches written once
    timed("gather_patches_single", f"ORB frontend {tuple(smooth.shape)} N={n}",
          lambda: patch_gather.gather_patches(smooth, corner),
          lambda: patch_gather.gather_patches_reference(smooth, corner), 0,
          patch_bytes(smooth.shape, corner), library=lambda: windows[cy, cx], graph=True)

    stack = blur_stack(img)
    got = patch_gather.gather_patches_stack(stack, corner)
    ref = patch_gather.gather_patches_stack_reference(stack, corner)
    stack_windows = window_view(stack)
    torch.cuda.synchronize()
    results["gather_patches_stack"]["err"] = float((got - ref).abs().max())
    assert torch.equal(got, ref), "gather_patches_stack: kernel differs from plain"
    assert torch.equal(stack_windows[:, cy, cx], ref), "stack: library call differs from plain"
    print(f"  gather_patches_stack {tuple(stack.shape)} N={n} -> {tuple(got.shape)}: bit-equal to "
          f"the plain version")
    timed("gather_patches_stack", f"BRISK blur stack {tuple(stack.shape)} N={n}",
          lambda: patch_gather.gather_patches_stack(stack, corner),
          lambda: patch_gather.gather_patches_stack_reference(stack, corner), 0,
          patch_bytes(stack.shape[1:], corner, stack.shape[0]), library=lambda: stack_windows[:, cy, cx], graph=True)


def check_stack_path(cfg, img, card):
    """The stacked launch form, driven alone.  Its only caller in the
    reference is the BRISK/FREAK descriptor support, which is not ported, so
    no path of the system reaches it yet: this is that caller's one call (one
    octave's blur stack of a course image, patches at the detected corners)
    with the launch count at 0 before it, and the kernels line says so
    (``caller``).  Returns the launches."""
    from vloam_tpu_torch.ops import patch_gather

    _, corner = orb_corners(img, cfg)
    patch_gather.LAUNCHES_STACK = 0
    out = patch_gather.gather_patches_stack(blur_stack(img), corner)
    torch.cuda.synchronize()
    launches = patch_gather.LAUNCHES_STACK
    assert launches == 1 and bool(torch.isfinite(out).all())
    assert tuple(out.shape) == (len(BRISK_BLUR_SIGMAS), corner.shape[0], 32, 32)
    print(f"  gather_patches_stack on a BRISK octave's blur stack: {launches} launch, "
          f"{tuple(out.shape)} finite patches [{card}]")
    return launches


def check_variants(results, card):
    """Phase 3c: the measurement tool, in process.  Fills ``results`` for the
    eleven measurement kernels and returns their launches in the tool's run;
    then holds the four exact gathers to the host's windows on the tool's
    four cases (tools.gather_experiments.check_cases) and the five sweeps to
    their plain versions on the sweep, NaN and G5 cases (sweep_checks)."""
    from vloam_tpu_torch.ops import gather_variants as gv
    from vloam_tpu_torch.tools import gather_experiments as tool

    print(f"== phase 3c: patch-gather formulations (tools.gather_experiments.run) [{card}]")
    gv.reset_launches()
    rows = tool.run("cuda", runs=TIMING_RUNS)
    launches = dict(gv.LAUNCHES)
    _, _, _, imgs, meta = tool.make_inputs(torch.device("cuda"))
    print(f"  {tool.needed_line(imgs, meta)} [{card}]")
    print(f"  {tool.cluster_line()} [{card}]")
    for line in tool.report(rows, card)[:-1]:
        print(f"  {line}")
    for r in rows:
        assert r["correct"], f"{r['name']}: kernel differs from its plain version"
        if r["name"] in results and r["name"] != "gather_patches":
            bytes_ms = r["nbytes"] / PEAK_BW * 1e3
            results[r["name"]].update(ms=r["ms"], plain_ms=r["plain_ms"], bytes_ms=bytes_ms,
                                      device_ms=r["device_ms"], library_ms=r["library_ms"],
                                      err=r["max_abs_err"])
            if r["library_device_ms"] is not None:
                results[r["name"]]["library_device_ms"] = r["library_device_ms"]
            print(f"  {r['name']}: equal to its plain version; {launches[r['name']]} launches; "
                  f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms (median of "
                  f"{TIMING_RUNS}), {r['device_ms']:.4f} ms a call inside a CUDA graph; bound "
                  f"{bytes_ms:.5f} ms ({r['nbytes'] / 1e6:.3f} MB); library "
                  + ("none" if r["library_ms"] is None else
                     f"{r['library_ms']:.4f} ms ({r['library_device_ms']:.4f} ms inside a graph)")
                  + f" [{card}]")
    for line, ok in tool.check_cases("cuda") + tool.sweep_checks("cuda"):
        print(f"  {line} [{card}]")
        assert ok, line
    print("  the sweeps' bounds (G1-G5) are the padded images read once over the HBM rate, while "
          "by their definition G1-G4 read every overlapping strip (4.6x the images) and G5 the "
          "images ten times, after the first pass from L2: none can reach half such a bound and "
          "stay the sweep it is.  Every gather's bound (B2's forms, G6-G11) counts the image "
          "floats its windows read, once, with the corners or meta and the output (the "
          "bytes-needed line).  library: one amax "
          "over the strips' view (G1, G2, G5) or one index call on the view of all windows "
          "(G6, G9-G11; G7 and G8 at their windows' origins, computed before the timed call); "
          "none for G3, G4 (a maximum per strip, then a sum per eleven: two reductions)")
    return launches


def check_stream_ptr(dev, card):
    """The stream handle every wrapper launches on (``kernels.stream_ptr``)
    is PyTorch's current stream's, outside a graph capture and inside one,
    where the current stream is the capture's side stream."""
    from vloam_tpu_torch import kernels

    outside = (kernels.stream_ptr(dev), torch.cuda.current_stream(dev).cuda_stream)
    x = torch.zeros(1, device=dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        inside = (kernels.stream_ptr(dev), torch.cuda.current_stream(dev).cuda_stream)
        x.add_(1)
    graph.replay()
    torch.cuda.synchronize()
    assert outside[0] == outside[1] and inside[0] == inside[1] and inside[0] != outside[0], \
        (outside, inside)
    print(f"  kernels.stream_ptr equals torch.cuda.current_stream(dev).cuda_stream outside "
          f"({outside[0]:#x}) and inside a graph capture ({inside[0]:#x}) [{card}]")


def count_gather_kernels(card):
    """The device kernels one call of B2's pair, single-image and stacked
    forms, G1-G5 and G7-G11 runs on the tool's inputs, by torch.profiler: one
    each (no PyTorch operation before the launch).  A call whose profile
    shows no device event in the retries of ``device_kernels`` fails the run:
    every count must be measured.  Run after every timed phase, as
    count_gn_kernels."""
    from vloam_tpu_torch.tools import gather_experiments as tool

    print(f"== device kernels per B2 pair / single / stack, G1-G5 / G7-G11 wrapper call "
          f"(torch.profiler) [{card}]")
    for line, names in tool.kernels_per_call():
        print(f"  {line} [{card}]")
        assert names is not None and len(names) == 1, line


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
        assert torch.equal(got[0], want[0]), f"{name}: points differ from the fused path's"
        # the fused path searches under the radius: a neighbour beyond it is
        # index 0 there, which no valid fit reads (the gate lies inside the radius)
        ok = want[3]
        for i in (1, 2):
            assert torch.equal(got[i][ok], want[i][ok]), \
                f"{name}: output {i} differs from the fused path's on a valid row"
        print(f"  {name}: {int(got[3].sum())} valid of {int(smask.sum())} live queries; points and "
              f"valid mask bit-equal to the fused path's, fits bit-equal on every valid row")


def check_single_association(cfg, calls, card):
    """Phase 3b: the path of the single-problem kernel.  MO's optimisation
    (two outer iterations of association + fits + fused GN) with one k-NN
    launch per feature type, from the captured pose and submap of the last
    warm-up frame, against the same loop through ``knn_pair``.  Returns the
    kernel's launches on this path."""
    from vloam_tpu_torch.models import laser_mapping as lm
    from vloam_tpu_torch.ops import fused_gn, fused_knn, knn

    last = KERNEL_FRAME
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


def check_driver(cfg, frames, card, step_per_frame, step_syncs):
    """Phase 7: the runtime entry point on the card, with the native host
    library (``check_host_library``).  Returns whether the library is in use."""
    from vloam_tpu_torch.data import synthetic
    from vloam_tpu_torch.ops import fused_gn, fused_knn, patch_gather
    from vloam_tpu_torch.runtime import driver as drv
    from vloam_tpu_torch.utils.trajectory import load_kitti_trajectory

    print(f"== phase 7: runtime.driver.run_synthetic, kitti_hdl64, {N_FRAMES} frames, "
          f"n_azimuth=1800 [{card}]")
    host_lib = check_host_library(cfg, frames, card)
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
          f"scan and image synthesis; host stages {'in the native library' if host_lib else 'in NumPy'} [{card}]")
    del driver, seen
    return host_lib


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


def check_cli(card, *flags):
    """Phase 8b: ``python -m vloam_tpu_torch.runtime`` in a subprocess, on
    its default device, with ``flags`` added."""
    cmd = [sys.executable, "-m", "vloam_tpu_torch.runtime", "--dataset", "synthetic",
           "--frames", "4", "--json", *flags]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    assert res.returncode == 0, f"CLI exited {res.returncode}:\n{res.stderr[-3000:]}"
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, f"CLI printed {len(lines)} lines, want one JSON line:\n{res.stdout}"
    out = json.loads(lines[0])
    assert out["frames"] == 4 and np.isfinite(out["final_err_mo_m"]), out
    assert np.isfinite(out["final_err_vo_m"]), out
    assert out["final_err_mo_m"] / out["path_len_m"] <= DRIFT_TOL, out
    print(f"  {' '.join(cmd[1:])}: exit 0 in {time.perf_counter() - t0:.1f} s, one JSON line: "
          f"{lines[0]} [{card}]")


def check_descriptor_mode(cfg, ext, dframes, poses, card, step_syncs):
    """Phase 9: the full step in (D) with VO matching ORB descriptors instead
    of tracking.  Returns the launches of the single-image patch gather."""
    import dataclasses

    from vloam_tpu_torch.models.vloam import init_vloam_state, vloam_step
    from vloam_tpu_torch.ops import fused_gn, fused_knn, orb, patch_gather

    print(f"== phase 9: full step vloam_step (D), descriptor-match mode (ORB, brute-force "
          f"Hamming), kitti_hdl64, {len(dframes)} frames [{card}]")
    ocfg = cfg.replace(visual=dataclasses.replace(cfg.visual, optical_flow_match=False,
                                                  descriptor_type="orb"))
    dev = dframes[0][0].device
    fresh_device(dev)
    counters = dict(launch_counters(), gather_single=lambda: patch_gather.LAUNCHES_SINGLE)
    fused_knn.LAUNCHES = fused_gn.LAUNCHES = fused_gn.LAUNCHES_VO = 0
    patch_gather.LAUNCHES = patch_gather.LAUNCHES_SINGLE = 0
    vo_states = []

    def step(s, f):
        img, g, m, bk, lf = f
        s, out = vloam_step(s, img, g, m, ext, ocfg, pre_gridded=True, pre_buckets=bk,
                            pre_lf_table=lf)
        vo_states.append(s.vo)
        return s, out

    state = init_vloam_state(ocfg, dev)
    first_vo = state.vo
    state, outs, frame_ms, per_frame, syncs = drive(step, state, dframes, counters)
    launches = patch_gather.LAUNCHES_SINGLE

    for i in range(len(dframes)):
        got = {name: per_frame[name][i] for name in counters}
        want = {"knn_pair": 4 if i else 0, "gn_lidar": 4 if i else 0, "gn_vo": 1,
                "gather_patches": 0, "gather_single": 1}
        assert got == want, f"descriptor-mode frame {i}: launches {got}, want {want}"
    for i, out in enumerate(outs):
        for name, v in out._asdict().items():
            assert bool(torch.isfinite(v.to(torch.float32)).all()), \
                f"descriptor-mode frame {i}: non-finite {name} {v}"
    check_lidar(outs, poses, "descriptor mode")

    # the matches each frame's solve saw, recomputed from the rolled descriptors
    matches = []
    for prev, cur in zip([first_vo] + vo_states[:-1], vo_states):
        assert cur.prev_desc.dtype == torch.int32
        _, valid = orb.match_descriptors(prev.prev_desc, prev.prev_desc_mask, cur.prev_desc,
                                         cur.prev_desc_mask, ratio=ocfg.visual.match_ratio,
                                         select=ocfg.visual.match_select)
        matches.append(int(valid.sum()))
    assert min(matches[1:]) >= MIN_ORB_MATCHES, \
        f"valid matches per frame {matches}, want >= {MIN_ORB_MATCHES} from frame 1"
    assert syncs.count <= step_syncs.count, \
        f"frame {SYNC_FRAME}: {syncs.count} synchronising calls, KLT mode makes {step_syncs.count}"

    path = SPEED * (len(outs) - 1)
    vo_err = float(np.linalg.norm(outs[-1].world_vo[4:].cpu().numpy() - poses[len(outs) - 1][1]))
    worst_t = max(float(np.abs(outs[i].vo_delta[4:].cpu().numpy().astype(np.float64)
                               - gt_delta(poses, i)[1]).max()) for i in range(1, len(outs)))
    print(f"  launches per frame: {', '.join(f'{k} {v[:3]}...' for k, v in per_frame.items())}")
    print(f"  valid matches per frame: {matches} (bound >= {MIN_ORB_MATCHES} from frame 1); "
          f"corners described on the last frame: {int(vo_states[-1].prev_desc_mask.sum())}")
    print(f"  VO (not gated): worst f2f translation axis error {worst_t * 100:.2f} cm; final "
          f"error {vo_err:.3f} m ({vo_err / path * 100:.2f} %) over {path:.1f} m")
    print(f"  {ms_line(frame_ms, 5, card)}")
    print(f"  synchronising calls in frame {SYNC_FRAME}: {syncs.count} ({', '.join(syncs.sites)}); "
          f"KLT mode (phase 5): {step_syncs.count}"
          + (f"; other warnings: {syncs.other}" if syncs.other else ""))
    del state, vo_states
    return launches



def check_host_library(cfg, frames, card):
    """Phase 7a: build the native host library (g++), or say why this
    machine cannot; a build that fails where it can is a failure.  Then,
    on phase 2's ring grids, the NumPy host stages against the library's
    twins by direct calls: equal within tests/test_native.py's tolerances
    except where a value sits within float32 rounding of a bucket or voxel
    edge (``compare_buckets``, ``compare_lf_tables``), and host ms a call
    each way (median over the grids).  Returns whether the library is in
    use."""
    from vloam_tpu_torch.data import gridding
    from vloam_tpu_torch.data.stream import camera_matrices
    from vloam_tpu_torch.models.frame_graph import kitti_default_extrinsics
    from vloam_tpu_torch.runtime import native

    missing = native.toolchain_missing()
    if missing:
        print(f"  native host library: cannot be built on this machine ({missing}); the "
              f"driver runs the NumPy host path, and the library's comparisons are not run")
        return False
    t0 = time.perf_counter()
    so = native.build()          # raises with the compiler's output
    build_s = time.perf_counter() - t0
    assert native.available(), f"{so} built but does not load"
    print(f"  native host library: {so.relative_to(os.path.dirname(os.path.abspath(__file__)))} "
          f"in {build_s:.2f} s; libpng: {native.png_route()[1]}")
    proj = camera_matrices(kitti_default_extrinsics("cpu"))[1]
    ms = collections.defaultdict(list)

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        ms[name].append((time.perf_counter() - t) * 1e3)
        return out

    edge_buckets, edge_cells, moved, run_gap, gap = 0, 0, 0, 0, 0.0
    for _, grid, gmask, _, _ in frames:
        flat, fmask = grid.reshape(-1, 4), gmask.reshape(-1)
        pb = timed("depth_buckets (NumPy)", gridding.depth_buckets, flat, fmask, proj, cfg.visual)
        nb = timed("depth_buckets_native", native.depth_buckets_native, flat, fmask, proj,
                   cfg.visual)
        pt = timed("less_flat_voxel_table (NumPy)", gridding.less_flat_voxel_table, grid, gmask,
                   cfg.scan)
        nt = timed("lf_voxel_table_native", native.lf_voxel_table_native, grid, gmask, cfg.scan)
        n_b, g_b = compare_buckets(flat, fmask, proj, cfg.visual, pb, nb)
        n_c, n_m, n_r = compare_lf_tables(grid, gmask, cfg.scan.less_flat_voxel, pt, nt)
        edge_buckets, edge_cells, moved, run_gap = (edge_buckets + n_b, edge_cells + n_c,
                                                    moved + n_m, run_gap + n_r)
        gap = max(gap, g_b)
    print(f"  host stages by direct calls on phase 2's {len(frames)} grids (host ms a call, "
          f"median / min / max) [{card}]:")
    for name, v in ms.items():
        print(f"    {name:<32} {statistics.median(v):8.3f} {min(v):8.3f} {max(v):8.3f}")
    print(f"  native vs NumPy over the {len(frames)} grids: depth buckets: counts equal but in "
          f"{edge_buckets} bucket(s) that a point within float32 rounding of a bucket edge may "
          f"fall in; the other buckets' means within {gap:.2e} (bound 2e-3); less-flat table: "
          f"{moved} run start(s) moved, each at or just after one of the {edge_cells} cells "
          f"within float32 rounding of a voxel edge (the library quantizes by a reciprocal "
          f"multiply, NumPy divides), "
          f"{run_gap} run(s) more or fewer in all; every other run's sums within rtol 1e-5 / "
          f"atol 1e-4")
    return True


EPS32 = 2.0 ** -24    # float32 unit roundoff


def compare_buckets(flat, fmask, proj, vc, pb, nb):
    """The library's depth buckets (u, v, z, count) against NumPy's: both
    project in float32 with their sums in another order, so a point within
    float32 rounding of a bucket edge may land on either side.  Counts are
    equal outside the buckets such points may fall in, means there within
    2e-3.  Returns (buckets whose counts differ, largest gap of the other means)."""
    pts = flat[:, :3].astype(np.float64)
    P = proj.astype(np.float64)
    uvz = pts @ P[:, :3].T + P[:, 3]
    zs = np.maximum(uvz[:, 2], 1e-6)
    ok = fmask & (uvz[:, 2] > vc.min_projection_depth)
    g = vc.downsample_grid
    bw, bh = pb[3].shape
    pos = uvz[:, :2] / zs[:, None] / g                  # (u, v) in bucket units
    cell = np.floor(pos).astype(np.int64)
    allowed = np.zeros((bw, bh), bool)
    for axis in (0, 1):
        # float32 rounding of the dot product, of the division by depth and by g
        tol = (8 * EPS32 * (np.abs(pts) @ np.abs(P[axis, :3]) + abs(P[axis, 3])) / zs / g
               + 8 * EPS32 * np.abs(pos[:, axis]) + 1e-6)
        near = ok & (np.abs(pos[:, axis] - np.round(pos[:, axis])) <= tol)
        for side in (-1, 0):                            # the buckets either side of the edge
            c = cell[near].copy()
            c[:, axis] = np.round(pos[near, axis]).astype(np.int64) + side
            inb = (c[:, 0] >= 0) & (c[:, 0] < bw) & (c[:, 1] >= 0) & (c[:, 1] < bh)
            allowed[c[inb, 0], c[inb, 1]] = True
    differ = pb[3] != nb[3]
    assert not (differ & ~allowed).any(), \
        f"depth buckets: counts differ away from bucket edges at {np.argwhere(differ & ~allowed)[:5]}"
    gap = max(float(np.abs(a[~allowed] - b[~allowed]).max()) for a, b in zip(pb[:3], nb[:3]))
    assert gap <= 2e-3, f"depth buckets: means differ by {gap}"
    return int(differ.sum()), gap


def compare_lf_tables(grid, gmask, leaf, pt, nt):
    """The library's less-flat table against NumPy's.  The library
    quantizes by a reciprocal multiply (``floor((x - p_min) * (1 / leaf))``),
    NumPy and the device by a division, so a cell within float32 rounding of
    a voxel edge may fall in the neighbouring voxel: only there (at such a
    cell or the one after it) may a run start, and with it the run count and
    every later slot number, differ; every run that holds no such cell has
    equal sums within rtol 1e-5 / atol 1e-4.  Returns (cells within rounding
    of an edge, run starts moved, runs more or fewer)."""
    (ps, pbase, pn), (ns, nbase, nn) = pt, nt
    valid = gmask.reshape(-1)
    xyz = grid.reshape(-1, 4)[:, :3].astype(np.float64)
    p_min = xyz[valid].min(axis=0)
    q = (xyz - p_min) / np.float64(np.float32(leaf))   # position in voxel units
    tol = 8 * EPS32 * (np.abs(xyz) + np.abs(p_min)) / leaf + 8 * EPS32 * np.abs(q) + 1e-6
    near = valid & np.any(np.abs(q - np.round(q)) <= tol, axis=1)
    affected = near | np.concatenate([[False], near[:-1]])
    sp, sn = ps.reshape(-1), ns.reshape(-1)

    def starts(s):
        return (s >= 0) & (s != np.concatenate([[-1], s[:-1]]))

    moved = starts(sp) != starts(sn)
    assert not (moved & ~affected).any(), \
        f"less-flat table: run starts differ away from voxel edges at {np.flatnonzero(moved & ~affected)[:5]}"
    assert abs(nn - pn) <= int(moved.sum()), f"less-flat table: {nn} runs vs {pn}"
    touched = np.isin(sp, sp[affected & (sp >= 0)]) | np.isin(sn, sn[affected & (sn >= 0)])
    clean = valid & (sp >= 0) & (sn >= 0) & ~touched
    np.testing.assert_allclose(nbase[sn[clean]], pbase[sp[clean]], rtol=1e-5, atol=1e-4)
    return int(near.sum()), int(moved.sum()), abs(nn - pn)


def png_gray(img: np.ndarray) -> bytes:
    """An 8-bit grayscale PNG of ``img`` (values clipped to 0..255), written
    with zlib alone."""
    a = np.clip(img, 0, 255).astype(np.uint8)
    h, w = a.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a], axis=1).tobytes()   # filter 0 a row

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows, 6)) + chunk(b"IEND", b""))


def write_kitti_drive(root, ext, raw, date="2026_03_15", seq="0001"):
    """The frames as a KITTI raw drive under ``root``: the calibration files
    of ``ext`` (calib_velo_to_cam R:/T:, calib_cam_to_cam R_rect_00:/P_rect_00:),
    velodyne .bin files (x y z reflectance float32) and 8-bit PNG images."""
    fmt = lambda a: " ".join(f"{v:.12e}" for v in np.asarray(a, np.float64).ravel())  # noqa: E731
    date_dir = os.path.join(root, date)
    cam_T_velo = ext.cam_T_velo.cpu().numpy()
    drive_dir = os.path.join(date_dir, f"{date}_drive_{seq}_sync")
    velo = os.path.join(drive_dir, "velodyne_points", "data")
    imgs = os.path.join(drive_dir, "image_00", "data")
    os.makedirs(velo)
    os.makedirs(imgs)
    with open(os.path.join(date_dir, "calib_velo_to_cam.txt"), "w") as f:
        f.write(f"R: {fmt(cam_T_velo[:3, :3])}\nT: {fmt(cam_T_velo[:3, 3])}\n")
    with open(os.path.join(date_dir, "calib_cam_to_cam.txt"), "w") as f:
        f.write(f"R_rect_00: {fmt(ext.R_rect0.cpu().numpy()[:3, :3])}\n"
                f"P_rect_00: {fmt(ext.P_rect0.cpu().numpy())}\n")
    for i, (img, cloud) in enumerate(raw):
        xyzr = np.concatenate([cloud, np.zeros((len(cloud), 1), np.float32)], axis=1)
        xyzr.astype(np.float32).tofile(os.path.join(velo, f"{i:010d}.bin"))
        with open(os.path.join(imgs, f"{i:010d}.png"), "wb") as f:
            f.write(png_gray(img))
    return date, seq


def check_prefetcher(cfg, ext, raw, host_lib, card):
    """Phase 7b: ``run_kitti`` on a KITTI raw drive written from phase 2's
    first frames, through the native prefetcher (its threads read, decode
    and grid the frames) and through the NumPy loader loop; the exported
    rows agree within 5e-3 (native and NumPy depth buckets differ by up to
    2e-3 px, and float atomics move a few map inserts run to run)."""
    from vloam_tpu_torch.data.kitti import RawSequence
    from vloam_tpu_torch.ops import fused_gn, fused_knn, patch_gather
    from vloam_tpu_torch.runtime import driver as drv
    from vloam_tpu_torch.runtime import native
    from vloam_tpu_torch.utils.trajectory import load_kitti_trajectory

    print(f"== phase 7b: runtime.driver.run_kitti on a {len(raw)}-frame KITTI raw drive written "
          f"from phase 2's course, native prefetcher vs NumPy loaders [{card}]")
    if not host_lib:
        print("  not run: the native host library cannot be built on this machine (phase 7)")
        return
    counters = launch_counters()
    opened = []
    prefetcher = native.NativePrefetcher

    def tracked(*a, **kw):
        opened.append(prefetcher(*a, **kw))
        return opened[-1]

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        date, seq = write_kitti_drive(os.path.join(tmp, "kitti"), ext, raw)
        write_s = time.perf_counter() - t0
        runs = {}
        dev = ext.P_rect0.device
        for name in ("prefetcher", "NumPy"):
            fresh_device(dev)
            fused_knn.LAUNCHES = fused_gn.LAUNCHES = fused_gn.LAUNCHES_VO = 0
            patch_gather.LAUNCHES = 0
            out = os.path.join(tmp, name)
            with mock.patch.object(native, "NativePrefetcher", tracked), \
                    mock.patch.object(native, "available",
                                      (lambda: False) if name == "NumPy" else native.available):
                res = drv.run_kitti(cfg, RawSequence(os.path.join(tmp, "kitti"), date, seq),
                                    out_dir=out, verbose=False, device=dev)
            got = {k: get() for k, get in counters.items()}
            assert all(got.values()), f"run_kitti ({name}): a kernel was not launched: {got}"
            runs[name] = (res, {k: load_kitti_trajectory(os.path.join(out, f"{k}1.txt"))
                                for k in ("VO", "LO", "MO")}, got)
            if name == "prefetcher":
                assert len(opened) == 1 and opened[0]._h is None, \
                    "run_kitti did not read through one prefetcher, closed at the end"
        assert len(opened) == 1, "the NumPy run opened a prefetcher"
    (res_n, rows_n, got_n), (res_p, rows_p, got_p) = runs["prefetcher"], runs["NumPy"]
    assert got_n == got_p, f"launches differ: {got_n} vs {got_p}"
    worst = {}
    for k in rows_n:
        assert rows_n[k].shape == (len(raw), 3, 4) and np.isfinite(rows_n[k]).all(), k
        worst[k] = float(np.abs(rows_n[k] - rows_p[k]).max())
        assert worst[k] <= RESUME_TOL, f"{k}1.txt: prefetcher vs NumPy rows differ by {worst[k]}"
    print(f"  drive written in {write_s:.1f} s; exported rows, prefetcher vs NumPy loaders: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + f" (bound {RESUME_TOL}); "
          f"launches of each run {got_n}")
    print(f"  steady_ms_per_frame (median of process_grid, frames 2..{len(raw) - 1}): prefetcher "
          f"{res_n['steady_ms_per_frame']:.3f}, NumPy {res_p['steady_ms_per_frame']:.3f} [{card}]")


def check_raw_input(cfg, ext, raw, poses, card, step_per_frame, step_syncs):
    """Phase 11: the step on raw padded clouds (``pre_gridded=False``,
    ``pre_buckets=None``: ring gridding, depth buckets and the less-flat
    reduction on the device) against the pre-gridded step on the same
    frames with its inputs built by the host from the same clouds (the
    ring grid by ``grid_cloud``, the buckets by ``depth_buckets`` over the
    whole cloud, no less-flat table: the raw path reduces on the device).
    Neither makes more synchronising calls than phase 5's step."""
    from vloam_tpu_torch.data import gridding, stream, synthetic
    from vloam_tpu_torch.models.vloam import host_to_device, init_vloam_state, vloam_step
    from vloam_tpu_torch.ops import fused_gn, fused_knn, patch_gather
    from vloam_tpu_torch.ops.depth_map import DepthBuckets

    print(f"== phase 11: full step vloam_step (D) on raw padded clouds (pre_gridded=False, "
          f"pre_buckets=None), kitti_hdl64, {len(raw)} frames, against the pre-gridded step "
          f"[{card}]")
    dev = ext.P_rect0.device
    proj = stream.camera_matrices(ext)[1]
    raw_in, grid_in = [], []
    for img, cloud in raw:
        p, m = synthetic.pad_cloud(cloud, cfg.scan.max_points)
        grid, gmask, _ = gridding.grid_cloud(cloud, cfg.scan)
        bk = gridding.depth_buckets(p, m, proj, cfg.visual)
        t = lambda x: host_to_device(x, dev)  # noqa: E731
        raw_in.append((t(img), t(p), t(m), None))
        grid_in.append((t(img), t(grid), t(gmask), DepthBuckets(*(t(b) for b in bk))))
    results = {}
    for name, inputs, pre_gridded in (("raw", raw_in, False), ("pre-gridded", grid_in, True)):
        fresh_device(dev)
        counters = launch_counters()
        fused_knn.LAUNCHES = fused_gn.LAUNCHES = fused_gn.LAUNCHES_VO = patch_gather.LAUNCHES = 0

        def step(s, f, pre_gridded=pre_gridded):
            img, c, m, bk = f
            return vloam_step(s, img, c, m, ext, cfg, pre_gridded=pre_gridded, pre_buckets=bk)

        _, outs, frame_ms, per_frame, syncs = drive(step, init_vloam_state(cfg, dev), inputs,
                                                    counters)
        results[name] = (outs, frame_ms, per_frame, syncs)
    outs, frame_ms, per_frame, syncs = results["raw"]
    g_outs, g_ms, g_per_frame, g_syncs = results["pre-gridded"]
    want = {k: v[:len(raw)] for k, v in step_per_frame.items()}
    assert per_frame == want and g_per_frame == want, \
        f"launches per frame {per_frame} / {g_per_frame}, phase 5's {want}"
    for i, out in enumerate(outs):
        for name, v in out._asdict().items():
            assert bool(torch.isfinite(v.to(torch.float32)).all()), f"raw frame {i}: non-finite {name}"
    check_lidar(outs, poses, "raw step")
    diff = {k: float((getattr(outs[-1], k)[4:] - getattr(g_outs[-1], k)[4:]).abs().max())
            for k in ("world_lo", "world_mo", "world_vo")}
    assert all(d <= RESUME_TOL for d in diff.values()), \
        f"raw vs pre-gridded final positions differ: {diff} (bound {RESUME_TOL} m)"
    assert syncs.count <= g_syncs.count <= step_syncs.count, \
        (f"frame {SYNC_FRAME}: synchronising calls: raw step {syncs.count}, pre-gridded "
         f"{g_syncs.count}, phase 5's step {step_syncs.count}")
    print(f"  launches per frame equal phase 5's: "
          f"{', '.join(f'{k} {v[:3]}...' for k, v in per_frame.items())}")
    print(f"  final position, raw vs pre-gridded step: "
          + ", ".join(f"{k} {v:.2e} m" for k, v in diff.items()) + f" (bound {RESUME_TOL} m)")
    print(f"  synchronising calls in frame {SYNC_FRAME}: raw {syncs.count} ({', '.join(syncs.sites)}), "
          f"pre-gridded {g_syncs.count}, phase 5's step {step_syncs.count}"
          + (f"; other warnings: {syncs.other}" if syncs.other else ""))
    print(f"  raw step {ms_line(frame_ms, 5, card)}")
    print(f"  pre-gridded step {ms_line(g_ms, 5, card)}")


def check_validation_drive(cfg, ext, card):
    """Phase 12: the validation drive of ``tools/validate_drive`` (snake
    course, speed 0.9, yaw amplitude 0.004) on VALIDATION_FRAMES frames made
    once, in (D) with the unreliable-point exclusion off and then on: MO
    final error within DRIFT_TOL of the path in both."""
    import dataclasses

    from vloam_tpu_torch.data import stream
    from vloam_tpu_torch.ops import fused_gn, fused_knn, patch_gather
    from vloam_tpu_torch.tools import validate_drive

    print(f"== phase 12: tools.validate_drive, snake course, kitti_hdl64, {VALIDATION_FRAMES} "
          f"frames, (D) without and with exclude_unreliable [{card}]")
    t0 = time.perf_counter()
    frames, poses = stream.gen_frames(cfg, ext, VALIDATION_FRAMES, speed=0.9, yaw_rate=0.004,
                                      snake=True)
    gen_s = time.perf_counter() - t0
    counters = launch_counters()
    for excl in (False, True):
        vcfg = cfg.replace(scan=dataclasses.replace(cfg.scan, exclude_unreliable=excl))
        fresh_device(ext.P_rect0.device)
        fused_knn.LAUNCHES = fused_gn.LAUNCHES = fused_gn.LAUNCHES_VO = patch_gather.LAUNCHES = 0
        rec = validate_drive.drive(vcfg, ext, frames, poses, frame_gen_s=gen_s)
        got = {k: get() for k, get in counters.items()}
        n = VALIDATION_FRAMES
        assert got == {"knn_pair": 4 * (n - 1), "gn_lidar": 4 * (n - 1), "gn_vo": n,
                       "gather_patches": n + 4}, f"{rec['mode']}: launches {got}"
        assert rec["final_err_pct"] <= DRIFT_TOL * 100, f"{rec['mode']}: {rec}"
        print(f"  {rec['mode']}: MO final error {rec['final_err_m']:.4f} m over "
              f"{rec['path_len_m']} m ({rec['final_err_pct']:.3f} %, bound {DRIFT_TOL * 100:.0f} %), "
              f"ATE {rec['ate_m']:.4f} m, mo_trans_pct {rec['mo_trans_pct']} "
              f"({rec['segments']} segments of 100 m or more), steady "
              f"{rec['steady_ms_per_frame']:.3f} ms/frame (frames {validate_drive.STEADY_FROM}.."
              f"{n - 1}, one fetch at the end); launches {got} [{card}]")
    print(f"  {VALIDATION_FRAMES} frames made in {gen_s:.1f} s (not timed)")


if __name__ == "__main__":
    sys.exit(main())
