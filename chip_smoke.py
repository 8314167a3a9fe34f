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
   at level 0 of a tracked frame, and its single-image launch form at the
   ORB frontend's shape (with ORB's pattern comparisons, the tap gather
   against the reference's TPU product, timed both ways); with the
   tolerances below, the median times of both (CUDA events, 20 runs), for
   the k-NN and Gauss-Newton kernels, the KLT gather at level 0 and the
   single form (and the gathers' index-call library) the device time per
   call when 20 calls are captured in one CUDA graph and replayed, with its
   share of the kernel's roofline bound, and each kernel's bound (a
   gather's counts the image floats its windows read, once, and the share of
   the images they cover at the KLT's level-0 call).  The gather's stacked
   form at BRISK's own calls and its single form at SIFT's (P = 24) are
   checked and timed the same way after phase 14, on the calls phase 14's
   drives made.
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
   library), checked against ground truth, phase 5's launch counts (on
   frames 0-2; the driver replays CUDA graphs from frame 2, where it
   captures them, and after it B1 alone launches through its wrapper),
   and the count of synchronising calls of a steady frame; VloamDriver's stage
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
   ms/frame;
13. the frame step's options at full width, each part with its seconds:
   (a) lidar undistortion: ``tests/test_distortion.py``'s two-frame
   contract (a rigid sweep, then one motion-distorted sweep: the
   interpolated LO solve within 8 cm of the true motion and under half the
   rigid-sweep solve's error), then 12 frames of the full step in (D) with
   ``distortion=True`` on phase 2's images and clouds swept over each
   frame's motion (``simulate_scan_distorted``): launches, and printed, not
   gated, drift, syncs and ms/frame (the same frames without distortion
   beside);
   (b) ``insert_dedup=False`` (the reference's re-voxelised map) beside the
   dedup path on one LO run's feature clouds of phase 2's first 12 frames:
   ``tests/test_mapping_policy_parity.py``'s three asserts, MO ms/frame,
   syncs and launches of each; (c) VO with ``clahe``, ``keypoint_nms`` and
   the FAST detector, 12 frames of the full step: VO drift, the fewest
   tracks a frame, launches; (d) ``run_synthetic`` with ``debug_dir``,
   ``debug_every=5`` over 10 frames: the PNG counts, each decoded to the
   image's shape;
14. the feature families: 12 frames of the full step in (D) for each of
   (brisk, brisk, bf), (brisk, freak, bf), (akaze, akaze, bf), (sift, sift,
   flann) and (fast, brief, flann) in descriptor mode, and the ORB detector
   in KLT mode, through ``vo_step``'s dispatch and the ImageUtil facade:
   launches a frame (B2 by form and window side: 8 stacked for BRISK and
   FREAK, 8 single at P = 24 for SIFT, 4 single at P = 32 for AKAZE, 1 for
   BRIEF), no more synchronising calls than phase 9, finite poses, MO within
   3 %; printed, not gated: the fewest matches (or tracks) a frame, the VO
   end error, ms/frame.
15. the last modules: (a) the epipolar VO solvers on the card, on the KLT
   tracks of phase 2's frame pair (1, 2) (N = 1024 slots, H = 256) and on a
   two-view case of ``tests/test_epipolar.py``'s kind at N = 1024:
   ``solve_ransac``'s samples equal to the NumPy threefry draw, its pose and
   ``solve_nls_2d_only``'s held to the same functions on the CPU and to the
   ground truth, ms (CUDA events) and synchronising calls a call; (b) the
   map-sharded full step (``parallel/vloam_shard``) at S = 1 over NCCL (one
   rank in this process, a file store) on phase 2's first 12 frames beside
   the single-device step: outputs within 1e-5, map counts within
   max(5, 0.5 %), the same B1-B4 launches a frame, ms and syncs a frame;
   (c0) the property (c) rests on: ``knn_pair``'s kernel rebases to the box
   of its masked rows, rows past the candidate count included (d2 and
   indices bit-equal to the plain version with a window's and with a rank
   slice's box past the count, near ties split between the two);
   (c) S = 2 on the one card: NCCL's refusal of two ranks on one device
   shown, then two spawned gloo ranks (CUDA tensors copied through host
   memory) on the same frames: poses within 1e-5 of (b) (every rank
   rebases its searches to the whole window's centre), rank-summed map
   counts, each rank's block, the merge's bytes equal to
   ``merge_payload_bytes``, phase 10's pose-graph factors split over the
   two ranks within 2e-4 of the unsharded solve; ms a frame (a shared card
   and a host transport, not a multi-GPU number).
16. the system-level drives through their tools' functions: ``ops/
   cellhash``'s ``cell_knn`` on the street's map (8192 queries) against
   the exact k-NN of the points its table kept, within the 1 m gate (the
   table grown by two appends from an empty one equal to it), and
   the ms of its two steps beside the brute search's; ``tools.loop_drive``
   over two laps of a 160-frame ring (finite poses, at least one accepted
   loop factor, the drift-scaled gate detecting at least what the fixed
   one does, the refinement report; the raycast's, the frames' and
   ``close()``'s seconds); ``tools.coupling_scenarios``' corridor (24
   frames) and highway (40) in both modes (coupled wins in the corridor and
   loses on the highway); each drive's launches counted from 0, every
   kernel of its path launched.

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
# phase 13: tests/test_distortion.py's two-frame contract, and the debug dumps' run
DISTORTION_ON_TOL, DISTORTION_GAIN = 0.08, 0.5   # err_on < 0.08 m, err_on < 0.5 err_off
DEBUG_FRAMES, DEBUG_EVERY = 10, 5
MIN_TRACKS = 10          # vo_step solves only with >= 10 tracks (visual_odometry.py)
# phase 15
TRACK_FRAME = 2          # the frame whose KLT tracks (from frame 1) the epipolar solvers take
N_HYPOTHESES = 256       # RANSAC's hypotheses (ops/epipolar.py)
RANSAC_ROT_TOL, RANSAC_COS_MIN = 5e-3, 0.99   # tests/test_epipolar.py:44-48
NLS_ROT_TOL, NLS_COS_MIN = 2e-3, 0.999        # tests/test_epipolar.py:98-101
# sharded vs single-device outputs in deterministic mode, (b) against the single step and (c)
# against (b): every rank rebases its searches to the whole window's centre, so the sharded step
# searches, merges and fits what the single step does; on the card both read 0, and (c) read
# 1.73e-3 when each rank rebased to its own slice's centre (tests/torch_shard_centre.py), so the
# bound is 1e-5 where tests/test_vloam_sharded.py:63-69 allows 5e-3
SHARD_TOL = 1e-5
REBASE_QUERIES = 20000   # (c0): queries on the bisector of two candidates 24 m down
PG_SHARD_TOL = 2e-4      # sharded vs unsharded pose-graph solve (tests/test_pose_graph.py:134)
SHARD_TIMEOUT = 300.0    # s, rendezvous, collectives and the join of the spawned ranks
# (b) and (c) start from the map lifted 24 m (wmap_wodom of frame 0): the ground lies in the
# cube layer below the sensor's, whose slots rank 1 owns at S = 2; from the identity the
# whole course lies in one layer, in rank 0's block (ROADMAP C-l)
SHARD_LIFT = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, -24.0)
# (b) and (c) and their references run with torch.use_deterministic_algorithms(True): with the
# default algorithms two runs of the same step differ by millimetres (the float atomics of
# voxel_downsample, ROADMAP C-b), which would hide what the sharding does to the outputs
# the S = 2 ranks' outputs: replicated; the ulp of a coordinate at 24 m is 1.9e-6, so this is
# ~50 ulp
RANKS_APART_TOL = 1e-4
# phase 14: descriptor mode with (detector, descriptor, matcher) of
# tests/test_vo_descriptor_modes.py:40-47 but ORB's (phase 9), then the ORB detector in KLT mode
FAMILY_CASES = (("brisk", "brisk", "bf"), ("brisk", "freak", "bf"), ("akaze", "akaze", "bf"),
                ("sift", "sift", "flann"), ("fast", "brief", "flann"))
# B2's launches a frame by form, and its window side, for each descriptor family:
# BRISK/FREAK sample upright, then rotated, at 4 octaves; SIFT orients, then describes, at 4
FAMILY_B2 = {"brisk": {"stack": 8}, "freak": {"stack": 8}, "akaze": {"single": 4},
             "sift": {"single": 8}, "brief": {"single": 1}}
FAMILY_P = {"brisk": 32, "freak": 32, "akaze": 32, "sift": 24, "brief": 32}
CAPTURE_FRAME = 5        # the frame of the BRISK and SIFT drives whose B2 calls phase 3 checks
# the ring course of tests/test_driver_loop_closure.py (phase 10)
RING_FRAMES, RING_SPEED = 56, 1.1
RING_KW = dict(keyframe_every=5, loop_radius=6.0, loop_min_travel=25.0, loop_drift_rate=0.02,
               loop_min_gap=3)

# phase 16: tools/loop_drive cut from 1500 frames to two laps of 160 (a 16.6 m ring, each lap
# 104 m, just past the 100 m a revisit must have travelled; the host raycast ~70 s); the
# scenarios at tests/test_coupling_modes.py's
# small-scale lengths; ops/cellhash at the sizes of its STATUS note (8192 queries, up to 49152
# candidates of the street at the map's 0.4 m voxel, a 16k-bucket table of 16 a bucket)
LOOP_FRAMES, LOOP_LAPS = 160, 2
CORRIDOR_FRAMES, HIGHWAY_FRAMES = 24, 40
CELL_QUERIES, CELL_CANDS, CELL_TABLE, CELL_CAP, CELL_K = 8192, 49152, 16384, 16, 5
CELL_D2_RTOL, CELL_D2_ATOL = 1e-4, 1e-5     # tests/test_cellhash.py:41 (two difference forms)

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
GATHER_FORMS = ("gather_patches_single", "gather_patches_stack", "gather_patches_single_p24")
GATHER_CALLERS = {   # where each form runs on the system's paths
    "gather_patches_single": "the ORB/BRIEF descriptors (phase 9), AKAZE's patches (phase 14)",
    "gather_patches_stack": "the BRISK/FREAK descriptors' blur stacks (phase 14)",
    "gather_patches_single_p24": "SIFT's orientation and descriptor patches (phase 14)",
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
    launches.update(check_variants(results, card))
    slice_syncs = check_slice(cfg, dframes[:N_SHORT], poses, card)
    step_launches, per_frame, step_syncs, step_ms = check_step(cfg, ext, dframes, poses, card,
                                                               slice_syncs)
    launches.update(step_launches)
    check_coupled(cfg, ext, dframes[:N_SHORT], poses, card)
    del dframes
    host_lib = check_driver(cfg, frames, card, per_frame, step_syncs)
    check_prefetcher(cfg, ext, raw, host_lib, card)
    check_resume(cfg, ext, frames[:N_RESUME], card)
    check_cli(card)
    check_cli(card, "--descriptor-match")
    dframes = [frame_to_device(*f, dev) for f in frames[:N_SHORT]]
    launches["gather_patches_single"], desc_syncs = check_descriptor_mode(cfg, ext, dframes, poses,
                                                                          card, step_syncs)
    del dframes
    launches["gn_lidar_batched"], graph = check_close(cfg, card)
    check_raw_input(cfg, ext, raw, poses, card, per_frame, step_syncs)
    short = frames[:N_SHORT]
    del frames
    check_validation_drive(cfg, ext, card)
    check_options(cfg, ext, raw, short, poses, card, per_frame)
    family_launches, captured = check_feature_families(cfg, ext, short, poses, card, per_frame,
                                                       desc_syncs)
    launches.update(family_launches)
    check_family_gathers(captured, results, card)
    for name, n in check_last_modules(cfg, ext, short, poses, card, per_frame, step_syncs, step_ms,
                                      graph).items():
        launches[name] += n
    del short, raw, captured
    for name, n in check_drives(cfg, card).items():
        launches[name] += n
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
    forms = [dict(entry(name), caller=GATHER_CALLERS[name]) for name in GATHER_FORMS]
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


def make_timer(results, card):
    """``timed(name, label, kernel, plain, ops, nbytes, library=None,
    graph=False)``: times the kernel's wrapper and its plain version (CUDA
    events), with ``graph`` its device time inside a replayed CUDA graph,
    prints them beside the bound (``ops`` over PEAK_F32, ``nbytes`` over
    PEAK_BW) and adds them up into ``results[name]``; ``library`` is the one
    PyTorch call for the same function.  Returns the kernel's ms."""
    from vloam_tpu_torch.tools.gather_experiments import graph_ms

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
            lib_ms = time_ms(library)
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
            lib_device = ""
            if graph:
                lib_dev = graph_ms(library)
                r["library_device_ms"] = r.get("library_device_ms", 0.0) + lib_dev
                lib_device = f" ({lib_dev:.4f} ms a call inside a replayed graph)"
            print(f"  {name} {label}: the one PyTorch call for the same function "
                  f"{lib_ms:.4f} ms{lib_device} [{card}]")
        return ms

    return timed


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
    from vloam_tpu_torch.tools.gather_experiments import (graph_ms, patch_bytes, window_floats,
                                                          window_view)

    last = KERNEL_FRAME
    print(f"== phase 3: kernels vs plain PyTorch versions, at the frame step's call shapes "
          f"(a {N_WARMUP}-frame warm-up drive of the full step; frames 1, {last} and "
          f"{REBUILT_FRAME}) [{card}]")
    state, calls = capture_calls(init_vloam_state(cfg, dframes[0][0].device), dframes[:N_WARMUP],
                                 ext, cfg, keep={1, last, REBUILT_FRAME})
    del state
    results = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
                   "library_ms": None} for k in (*KERNELS, *GATHER_FORMS)}
    timed = make_timer(results, card)

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
            # the library call: one index call on the view of every window of the
            # two images stacked beforehand (the stack's copy is not timed)
            pair_windows = window_view(torch.stack([args[0], args[1]]))
            n = args[2].shape[0]
            ids = torch.arange(2, device=img.device).repeat_interleave(n)
            cxy = torch.cat([args[2], args[3]]).to(torch.int64)
            assert torch.equal(pair_windows[ids, cxy[:, 1], cxy[:, 0]], torch.cat(ref)), \
                "pair: library call differs from plain"
            timed("gather_patches", f"{label} {tuple(img.shape)} N={got[0].shape[0]}",
                  lambda: patch_gather.gather_patches_pair(*args),
                  lambda: patch_gather.gather_patches_pair_reference(*args), 0, nbytes,
                  library=lambda: pair_windows[ids, cxy[:, 1], cxy[:, 0]], graph=True)
    check_gather_forms(cfg, dframes[last][0], timed, results)
    print("  library_ms is null for the k-NN and Gauss-Newton kernels: no single PyTorch call "
          "computes a masked k-NN with dynamic counts or a fused Gauss-Newton solve")
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
    launches in the run and the last pose-graph problem it solved."""
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

    graph = {}   # the last pose-graph problem close() solved: (poses, chain, loop factors)
    banded = drv.optimize_pose_graph_banded

    def recorded_banded(poses, chain, loop, *args, **kw):
        graph.update(poses=poses, chain=chain, loop=loop)
        return banded(poses, chain, loop, *args, **kw)

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
                              timed_stage("pose_graph", recorded_banded)):
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
    return batched, graph


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


def check_gather_forms(cfg, img, timed, results):
    """Phase 3, the single-image launch form of the patch gather against its
    plain version (equality) at the ORB frontend's shape, and its library
    call, one index call on the view of all the image's windows; then ORB's
    pattern comparisons on those patches (``check_descriptor_bits``).  The
    stacked form and the single form at P = 24 are held at their callers'
    own calls after phase 14 (``check_family_gathers``)."""
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
    check_descriptor_bits(got)


def matmul_bits(flat, abin):
    """ORB's 256 comparisons as one f32 product against the (30 * 256, 1024)
    matrix of +-1 tap differences, each keypoint then taking its angle
    bin's row block: the formulation the reference takes on the TPU
    (vloam_tpu/ops/orb.py:125-157), kept here only as a yardstick for
    ``orb._descriptor_bits``'s tap gather."""
    from vloam_tpu_torch.ops import orb

    k = orb._consts(flat.device)
    pix = torch.arange(orb.PATCH * orb.PATCH, device=flat.device)
    d = ((pix[None, :] == k["bank2"].reshape(-1)[:, None]).to(torch.float32)
         - (pix[None, :] == k["bank1"].reshape(-1)[:, None]).to(torch.float32))
    diff = (flat @ d.T).reshape(-1, orb.N_ANGLES, orb.N_BITS)
    return torch.gather(diff, 1, abin[:, None, None].expand(-1, 1, orb.N_BITS))[:, 0] > 0


def check_descriptor_bits(patches):
    """ORB's pattern comparisons (``orb._descriptor_bits``, a tap gather) on
    the ORB frontend's patches against ``matmul_bits``: equal bits, and the
    time of each (CUDA events and inside a replayed CUDA graph)."""
    from vloam_tpu_torch.ops import orb
    from vloam_tpu_torch.tools.gather_experiments import graph_ms

    flat = patches.reshape(patches.shape[0], -1)
    abin = torch.remainder(torch.arange(flat.shape[0], device=flat.device), orb.N_ANGLES)
    tap = lambda: orb._descriptor_bits(flat, abin)  # noqa: E731
    mm = lambda: matmul_bits(flat, abin)  # noqa: E731
    assert torch.equal(tap(), mm()), "ORB bits: the tap gather and the product differ"
    times = [f(g) for g in (tap, mm) for f in (time_ms, graph_ms)]
    print(f"  orb._descriptor_bits on the ORB frontend's {flat.shape[0]} patches (every angle "
          f"bin): tap gather {times[0]:.4f} ms ({times[1]:.5f} ms inside a replayed graph), "
          f"the +-1 product of the reference's TPU branch {times[2]:.4f} ms ({times[3]:.5f} ms); "
          f"equal bits")


def check_family_gathers(captured, results, card):
    """Phase 3, after phase 14: B2's stacked form at BRISK's own calls (one
    frame's four octave blur stacks, then the same four again for the
    rotated pass) and its single form at P = 24 at SIFT's own calls (one
    frame's four octave levels, 376x1248 down to 47x156, at SIFT's
    keypoints, then the same four again for the descriptor), each bit-equal
    to its plain version; the first four timed (CUDA events and inside a
    replayed CUDA graph) beside their bound (the image floats the windows
    read, the corners and the output) and their library call (one index
    call on the view of every window)."""
    from vloam_tpu_torch.ops import patch_gather
    from vloam_tpu_torch.tools.gather_experiments import patch_bytes, window_view

    timed = make_timer(results, card)
    print(f"== phase 3 at phase 14's calls: the patch gather's stacked form at BRISK's calls, its "
          f"single form at SIFT's (P = 24) [{card}]")
    for name, calls in (("gather_patches_stack", captured["stack"]),
                        ("gather_patches_single_p24", captured["single_p24"])):
        stacked = name == "gather_patches_stack"
        kernel, plain = ((patch_gather.gather_patches_stack,
                          patch_gather.gather_patches_stack_reference) if stacked else
                         (patch_gather.gather_patches, patch_gather.gather_patches_reference))
        assert len(calls) == 8, f"{name}: {len(calls)} calls on the captured frame, want 8"
        for i, args in enumerate(calls):
            imgs, corner, P = args
            got, ref = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            results[name]["err"] = max(results[name]["err"], float((got - ref).abs().max()))
            assert torch.equal(got, ref), f"{name} call {i}: kernel differs from plain"
            if i >= 4:
                continue
            windows = window_view(imgs, P)
            cx, cy = corner[:, 0], corner[:, 1]
            lib = ((lambda w=windows, x=cx, y=cy: w[:, y, x]) if stacked
                   else (lambda w=windows, x=cx, y=cy: w[y, x]))
            assert torch.equal(lib(), ref), f"{name} call {i}: library call differs from plain"
            nbytes = patch_bytes(tuple(imgs.shape[-2:]), corner, imgs.shape[0] if stacked else 1, P)
            timed(name, f"octave {i} {tuple(imgs.shape)} N={corner.shape[0]} P={P}",
                  lambda a=args: kernel(*a), lambda a=args: plain(*a), 0, nbytes, library=lib,
                  graph=True)
        print(f"  {name}: the frame's {len(calls)} calls bit-equal to the plain version; the "
              f"times above add up over its first 4 (one pass over the octaves)")


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
    return launches, per_frame, syncs, statistics.median(frame_ms[5:])


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

    # from the first steady frame on the driver replays its step from CUDA graphs
    # (models/graph_step): the wrappers run while that frame captures its segments,
    # and after it only B1 still launches through its wrapper
    eager = N_FRAMES - driver.timer.count["graph_step"]
    assert eager == 2, f"the step replayed from frame {eager} on, not from frame 2"
    assert {k: v[:eager + 1] for k, v in per_frame.items()} == \
        {k: v[:eager + 1] for k, v in step_per_frame.items()}, \
        f"launches per frame differ from phase 5: {per_frame} vs {step_per_frame}"
    assert per_frame["knn_pair"] == step_per_frame["knn_pair"] and all(
        not any(v[eager + 1:]) for k, v in per_frame.items() if k != "knn_pair"), \
        f"launches through the wrappers on replayed frames: {per_frame}"
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
    print(f"  launches per frame through the wrappers (phase 5's on the eager frames 0-1 and on "
          f"frame 2, which captures; B1's alone on the {N_FRAMES - eager - 1} frames after): "
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
    of tracking.  Returns the launches of the single-image patch gather and
    the SyncCounter of SYNC_FRAME."""
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
    return launches, syncs



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


def check_options(cfg, ext, raw, short, poses, card, step_per_frame):
    """Phase 13: the frame step's options at full width (module docstring)."""
    print(f"== phase 13: frame-step options, kitti_hdl64 [{card}]")
    for name, part in (("a", lambda: check_distortion(cfg, ext, raw, poses, card, step_per_frame)),
                       ("b", lambda: check_map_policy(cfg, ext, short, poses, card)),
                       ("c", lambda: check_frontend_options(cfg, ext, short, poses, card,
                                                            step_per_frame)),
                       ("d", lambda: check_debug_dumps(cfg, ext, card))):
        t0 = time.perf_counter()
        part()
        print(f"  ({name}) {time.perf_counter() - t0:.1f} s")


def lo_errors(outs, poses):
    """(worst LO f2f translation error (norm), final LO error, final MO error, path)."""
    worst = max(float(np.linalg.norm(out.lo_delta[4:].cpu().numpy() - gt_delta(poses, i)[1]))
                for i, out in enumerate(outs) if i)
    gt_end = poses[len(outs) - 1][1]
    lo = float(np.linalg.norm(outs[-1].world_lo[4:].cpu().numpy() - gt_end))
    mo = float(np.linalg.norm(outs[-1].world_mo[4:].cpu().numpy() - gt_end))
    return worst, lo, mo, SPEED * (len(outs) - 1)


def check_distortion(cfg, ext, raw, poses, card, step_per_frame):
    """13(a): the two-frame contract of tests/test_distortion.py, then the
    full step in (D) with distortion on distorted sweeps."""
    import dataclasses

    from vloam_tpu_torch.data import stream, synthetic
    from vloam_tpu_torch.models.lidar_odometry import init_lo_state, lo_step
    from vloam_tpu_torch.models.vloam import frame_to_device, init_vloam_state, vloam_step
    from vloam_tpu_torch.ops import fused_gn, fused_knn, patch_gather
    from vloam_tpu_torch.ops.scan_registration import extract_features

    dev = ext.P_rect0.device
    on = cfg.replace(odom=dataclasses.replace(cfg.odom, distortion=True))
    print(f"  (a) lidar undistortion (OdometryConfig.distortion) [{card}]")
    scene = synthetic.default_scene()
    (R1, t1), (R2, t2) = synthetic.straight_trajectory(3, speed=1.2, yaw_rate=0.02)[1:]
    sweeps = (synthetic.simulate_scan(R1, t1, scene, n_azimuth=1800, noise=0.004, seed=1),
              synthetic.simulate_scan_distorted(R1, t1, R2, t2, scene, n_azimuth=1800,
                                                noise=0.004, seed=2))
    t_true = R1.T @ (t2 - t1)
    err = {}
    for mode, c in (("on", on), ("off", cfg)):
        state = init_lo_state(c, dev)
        for pts in sweeps:
            p, m = synthetic.pad_cloud(pts, c.scan.max_points)
            feats = extract_features(torch.tensor(p, device=dev), torch.tensor(m, device=dev),
                                     c.scan)
            state, delta, _, _ = lo_step(state, feats, c)
        err[mode] = float(np.linalg.norm(delta[4:].cpu().numpy() - t_true))
    assert err["on"] < DISTORTION_ON_TOL and err["on"] < DISTORTION_GAIN * err["off"], \
        f"distortion contract: error with {err['on']} m, without {err['off']} m"
    print(f"    two-frame contract (speed 1.2 m, yaw 0.02 rad a sweep, n_azimuth 1800): LO f2f "
          f"error with distortion {err['on']:.4f} m (bound {DISTORTION_ON_TOL}), without "
          f"{err['off']:.4f} m (bound: with < {DISTORTION_GAIN} x without)")

    # phase 2's images; each cloud swept over the motion since the previous frame
    proj = stream.camera_matrices(ext)[1]
    boxes = synthetic.default_scene()
    box_cx = (boxes[:, 0] + boxes[:, 3]) / 2.0
    t0 = time.perf_counter()
    dframes = []
    for i, (img, cloud) in enumerate(raw):
        if i:
            (Ra, ta), (Rb, tb) = poses[i - 1], poses[i]
            near = boxes[np.abs(box_cx - tb[0]) < 100.0]
            cloud = synthetic.simulate_scan_distorted(Ra, ta, Rb, tb, near, n_azimuth=1800,
                                                      noise=0.005, seed=i)
        dframes.append(frame_to_device(*stream.host_frame(cfg, proj, img, cloud), dev))
    print(f"    {len(dframes)} distorted sweeps made in {time.perf_counter() - t0:.1f} s (not timed)")
    counters = launch_counters()
    runs = {}
    for mode, c in (("on", on), ("off", cfg)):
        fresh_device(dev)
        fused_knn.LAUNCHES = fused_gn.LAUNCHES = fused_gn.LAUNCHES_VO = patch_gather.LAUNCHES = 0

        def step(s, f, c=c):
            img, g, m, bk, lf = f
            return vloam_step(s, img, g, m, ext, c, pre_gridded=True, pre_buckets=bk,
                              pre_lf_table=lf)

        runs[mode] = drive(step, init_vloam_state(c, dev), dframes, counters)[1:]
    outs, frame_ms, per_frame, syncs = runs["on"]
    for i in range(len(dframes)):
        got = {name: per_frame[name][i] for name in counters}
        # LO solves with the generic GN (no B3): B3 runs in MO only
        want = {"knn_pair": 4 if i else 0, "gn_lidar": 2 if i else 0, "gn_vo": 1,
                "gather_patches": step_per_frame["gather_patches"][i]}
        assert got == want, f"distortion frame {i}: launches {got}, want {want}"
    for i, out in enumerate(outs):
        for name, v in out._asdict().items():
            assert bool(torch.isfinite(v.to(torch.float32)).all()), \
                f"distortion frame {i}: non-finite {name}"
    # Not gated: over many frames the sweep-end store feeds each frame's error
    # into the next one's targets, and the LO deltas oscillate (the JAX
    # lo_step gives the same deltas on the same features; the reference
    # tests the two-frame contract only and keeps its TransformToEnd off)
    for mode, what in (("on", "with distortion"), ("off", "the same frames without")):
        worst, lo_e, mo_e, path = lo_errors(runs[mode][0], poses)
        print(f"    {what} (not gated): LO f2f worst error {worst * 100:.2f} cm; final error LO "
              f"{lo_e:.3f} m ({lo_e / path * 100:.2f} %), MO {mo_e:.3f} m "
              f"({mo_e / path * 100:.2f} %) over {path:.1f} m")
    print(f"    launches per frame: {', '.join(f'{k} {v[:3]}...' for k, v in per_frame.items())}")
    print(f"    with distortion {ms_line(frame_ms, 5, card)}")
    print(f"    without distortion {ms_line(runs['off'][1], 5, card)}")
    print(f"    synchronising calls in frame {SYNC_FRAME}: with {syncs.count} "
          f"({', '.join(syncs.sites)}), without {runs['off'][3].count}"
          + (f"; other warnings: {syncs.other}" if syncs.other else ""))


def check_map_policy(cfg, ext, short, poses, card):
    """13(b): MO with insert_dedup=False (fresh window gather, every point
    inserted, the window re-voxelised) beside the dedup path, on one LO
    run's feature clouds; tests/test_mapping_policy_parity.py's asserts."""
    import dataclasses

    from vloam_tpu_torch.models.laser_mapping import init_map_state, mapping_step
    from vloam_tpu_torch.models.lidar_odometry import init_lo_state, lo_step
    from vloam_tpu_torch.models.vloam import frame_to_device
    from vloam_tpu_torch.ops import fused_gn, fused_knn
    from vloam_tpu_torch.ops.scan_registration import extract_features_from_grid

    dev = ext.P_rect0.device
    print(f"  (b) MappingConfig.insert_dedup=False beside the dedup path, {len(short)} frames [{card}]")
    lo, feeds = init_lo_state(cfg, dev), []
    for f in short:
        _, g, m, _, lf = frame_to_device(*f, dev)
        feats = extract_features_from_grid(g, m, m.sum(dim=1), cfg.scan, lf_table=lf)
        lo, _, world_lo, _ = lo_step(lo, feats, cfg)
        feeds.append((feats.less_sharp, feats.less_sharp_mask, feats.less_flat,
                      feats.less_flat_mask, world_lo))
    counters = {"knn_pair": lambda: fused_knn.LAUNCHES, "gn_lidar": lambda: fused_gn.LAUNCHES}
    gt = np.stack([t for _, t in poses[:len(short)]])
    res = {}
    for dedup in (True, False):
        mcfg = cfg.replace(mapping=dataclasses.replace(cfg.mapping, insert_dedup=dedup))
        fresh_device(dev)
        fused_knn.LAUNCHES = fused_gn.LAUNCHES = 0
        state, outs, frame_ms, per_frame, syncs = drive(
            lambda s, f, mcfg=mcfg: mapping_step(s, *f, mcfg), init_map_state(mcfg, dev), feeds,
            counters)
        for i in range(len(feeds)):
            got = (per_frame["knn_pair"][i], per_frame["gn_lidar"][i])
            assert got == ((2, 2) if i else (0, 0)), f"MO dedup={dedup} frame {i}: launches {got}"
        err = np.linalg.norm(torch.stack(outs)[:, 4:].cpu().numpy() - gt, axis=1)
        assert np.isfinite(err).all(), f"MO dedup={dedup}: non-finite pose"
        res[dedup] = (err, int(state.corner_cnt.sum() + state.surf_cnt.sum()), frame_ms, syncs)
        del state
    (err_fast, n_fast, ms_fast, sy_fast), (err_ref, n_ref, ms_ref, sy_ref) = res[True], res[False]
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    assert np.mean(err_fast) < 1.5 * np.mean(err_ref) + 0.01, \
        f"dedup mean MO error {np.mean(err_fast)} vs reference-exact {np.mean(err_ref)}"
    assert np.max(err_fast) / path < DRIFT_TOL, f"dedup MO errors {err_fast} over {path} m"
    assert n_ref < n_fast < 2 * n_ref, f"map points dedup {n_fast}, reference-exact {n_ref}"
    print(f"    MO error vs ground truth over {path:.1f} m: dedup mean {np.mean(err_fast):.4f} / max "
          f"{np.max(err_fast):.4f} m, reference-exact mean {np.mean(err_ref):.4f} / max "
          f"{np.max(err_ref):.4f} m (bounds: dedup mean < 1.5 x + 0.01, max < "
          f"{DRIFT_TOL * 100:.0f} % of the path); map points dedup {n_fast}, reference-exact "
          f"{n_ref} (bound ref < dedup < 2 ref); launches per frame 2 knn_pair + 2 gn_lidar on both")
    print(f"    MO mapping_step alone, dedup {ms_line(ms_fast, 5, card)}")
    print(f"    MO mapping_step alone, reference-exact {ms_line(ms_ref, 5, card)}")
    print(f"    synchronising calls of mapping_step in frame {SYNC_FRAME}: dedup {sy_fast.count} "
          f"({', '.join(sy_fast.sites)}), reference-exact {sy_ref.count} ({', '.join(sy_ref.sites)})")


def check_frontend_options(cfg, ext, short, poses, card, step_per_frame):
    """13(c): the full step in (D) with VO on CLAHE'd images, FAST corners and
    the bucketed keypoint NMS."""
    import dataclasses

    from vloam_tpu_torch import geometry as geo
    from vloam_tpu_torch.models.vloam import frame_to_device, init_vloam_state, vloam_step
    from vloam_tpu_torch.ops import fused_gn, fused_knn, image_ops, patch_gather

    dev = ext.P_rect0.device
    ocfg = cfg.replace(visual=dataclasses.replace(cfg.visual, clahe=True, keypoint_nms=True,
                                                  detector_type="fast"))
    print(f"  (c) VO with clahe, keypoint_nms and detector_type='fast', full step (D), "
          f"{len(short)} frames [{card}]")
    dframes = [frame_to_device(*f, dev) for f in short]
    fresh_device(dev)
    counters = launch_counters()
    fused_knn.LAUNCHES = fused_gn.LAUNCHES = fused_gn.LAUNCHES_VO = patch_gather.LAUNCHES = 0
    tracks, kept = [], []
    real_track = image_ops.lk_track_fb

    def track(*a, **k):
        curr, ok = real_track(*a, **k)
        tracks.append(ok.sum())              # read after the drive: no sync inside it
        return curr, ok

    def step(s, f):
        img, g, m, bk, lf = f
        s, out = vloam_step(s, img, g, m, ext, ocfg, pre_gridded=True, pre_buckets=bk,
                            pre_lf_table=lf)
        kept.append(s.vo.prev_pts_mask.sum())
        return s, out

    with mock.patch.object(image_ops, "lk_track_fb", track):
        _, outs, frame_ms, per_frame, syncs = drive(step, init_vloam_state(ocfg, dev), dframes,
                                                    counters)
    for i in range(len(dframes)):
        got = {name: per_frame[name][i] for name in counters}
        want = {"knn_pair": 4 if i else 0, "gn_lidar": 4 if i else 0, "gn_vo": 1,
                "gather_patches": step_per_frame["gather_patches"][i]}
        assert got == want, f"options frame {i}: launches {got}, want {want}"
    for i, out in enumerate(outs):
        for name, v in out._asdict().items():
            assert bool(torch.isfinite(v.to(torch.float32)).all()), \
                f"options frame {i}: non-finite {name}"
    n_tracks = [int(t) for t in tracks]
    n_kept = [int(k) for k in kept]
    nbx = -(-cfg.visual.img_width // cfg.visual.nms_bucket_width)
    nby = -(-cfg.visual.img_height // cfg.visual.nms_bucket_height)
    per_bucket = max(cfg.visual.nms_max_total // (nbx * nby), 1)
    assert min(n_tracks[1:]) >= MIN_TRACKS, f"tracks per frame {n_tracks}, want >= {MIN_TRACKS}"
    assert 0 < min(n_kept) and max(n_kept) <= per_bucket * nbx * nby, f"keypoints kept {n_kept}"
    worst = {"rot": 0.0, "cos": 1.0, "scale": 0.0}
    for i in range(2, len(outs)):
        R_rel, t_rel = gt_delta(poses, i)
        d = outs[i].vo_delta.cpu()
        est_t = d[4:].numpy().astype(np.float64)
        worst = {"rot": max(worst["rot"], float(np.abs(geo.quat_to_matrix(d[:4]).numpy()
                                                       - R_rel).max())),
                 "cos": min(worst["cos"], float(est_t @ t_rel / (np.linalg.norm(est_t)
                                                                 * np.linalg.norm(t_rel)))),
                 "scale": max(worst["scale"], abs(np.linalg.norm(est_t) - np.linalg.norm(t_rel))
                              / np.linalg.norm(t_rel))}
    path = SPEED * (len(outs) - 1)
    vo_err = float(np.linalg.norm(outs[-1].world_vo[4:].cpu().numpy() - poses[len(outs) - 1][1]))
    print(f"    tracks per frame (KLT forward-backward ok): {n_tracks} (fewest from frame 1: "
          f"{min(n_tracks[1:])}, bound >= {MIN_TRACKS}); keypoints kept by the NMS: {n_kept} "
          f"(<= {per_bucket} a bucket x {nbx * nby})")
    print(f"    VO (not gated): f2f from frame 2 worst rotation entry error {worst['rot']:.2e}, "
          f"direction cos {worst['cos']:.6f}, scale error {worst['scale'] * 100:.2f} %; final "
          f"error {vo_err:.3f} m ({vo_err / path * 100:.2f} %) over {path:.1f} m")
    print(f"    launches per frame: {', '.join(f'{k} {v[:3]}...' for k, v in per_frame.items())}")
    print(f"    {ms_line(frame_ms, 5, card)}")
    print(f"    synchronising calls in frame {SYNC_FRAME}: {syncs.count} ({', '.join(syncs.sites)})"
          + (f"; other warnings: {syncs.other}" if syncs.other else ""))


def check_debug_dumps(cfg, ext, card):
    """13(d): ``run_synthetic`` with the debug PNG dumps."""
    from PIL import Image

    from vloam_tpu_torch.runtime import driver as drv

    print(f"  (d) run_synthetic with debug_dir, debug_every={DEBUG_EVERY}, {DEBUG_FRAMES} frames "
          f"[{card}]")
    vc = cfg.visual
    with tempfile.TemporaryDirectory() as dbg:
        res = drv.run_synthetic(cfg, n_frames=DEBUG_FRAMES, n_azimuth=1800, verbose=False,
                                debug_dir=dbg, debug_every=DEBUG_EVERY, device=ext.P_rect0.device)
        names = sorted(os.listdir(dbg))
        dumped = range(0, DEBUG_FRAMES, DEBUG_EVERY)
        want = sorted([f"keypoints_{i:06d}.png" for i in dumped]
                      + [f"depth_{i:06d}.png" for i in dumped]
                      + [f"flow_{i:06d}.png" for i in dumped if i])
        assert names == want, f"debug files {names}, want {want}"
        for name in names:
            arr = np.asarray(Image.open(os.path.join(dbg, name)))
            assert arr.shape == (vc.img_height, vc.img_width, 3) and arr.dtype == np.uint8, \
                f"{name}: decoded to {arr.shape} {arr.dtype}"
            assert bool((arr[..., 0] != arr[..., 1]).any()), f"{name}: nothing drawn"
    print(f"    {len(names)} PNGs ({', '.join(names)}), each {vc.img_height}x{vc.img_width}x3 "
          f"uint8; MO final error {res['final_err_mo_m']:.3f} m; steady_ms_per_frame "
          f"{res['steady_ms_per_frame']:.3f} with the dumps on [{card}]")


def check_feature_families(cfg, ext, short, poses, card, step_per_frame, desc_syncs):
    """Phase 14: the full step in (D) with each feature family of the
    reference's frontend (``FAMILY_CASES``, through ``vo_step``'s dispatch
    and the ImageUtil facade), and the ORB detector in KLT mode.  Returns
    (B2's launches by the stacked form and by the single form at P = 24 over
    these drives, and the calls of the two forms on ``CAPTURE_FRAME`` of the
    BRISK and SIFT drives for ``check_family_gathers``)."""
    import dataclasses

    from vloam_tpu_torch import image_util as iu
    from vloam_tpu_torch.models.vloam import frame_to_device, init_vloam_state, vloam_step
    from vloam_tpu_torch.ops import (akaze, brisk, fused_gn, fused_knn, image_ops, orb,
                                     patch_gather, sift)

    dev = ext.P_rect0.device
    print(f"== phase 14: feature families, full step vloam_step (D), kitti_hdl64, {len(short)} "
          f"frames each [{card}]")
    launches = {"gather_patches_stack": 0, "gather_patches_single_p24": 0}
    captured = {"stack": [], "single_p24": []}
    for det, desc, matcher in FAMILY_CASES + (("orb", None, None),):
        klt = desc is None
        kw = (dict(detector_type=det) if klt else
              dict(optical_flow_match=False, detector_type=det, descriptor_type=desc,
                   matcher_type=matcher))
        fcfg = cfg.replace(visual=dataclasses.replace(cfg.visual, **kw))
        case = f"detector {det}, KLT" if klt else f"detector {det}, descriptor {desc}, {matcher}"
        dframes = [frame_to_device(*f, dev) for f in short]
        fresh_device(dev)
        counters = dict(launch_counters(), gather_single=lambda: patch_gather.LAUNCHES_SINGLE,
                        gather_stack=lambda: patch_gather.LAUNCHES_STACK)
        fused_knn.LAUNCHES = fused_gn.LAUNCHES = fused_gn.LAUNCHES_VO = 0
        patch_gather.LAUNCHES = patch_gather.LAUNCHES_SINGLE = patch_gather.LAUNCHES_STACK = 0
        frame, sides, vo_states, tracks = [0], collections.Counter(), [], []
        keep = {"brisk": "stack", "sift": "single_p24"}.get(desc)

        def recorder(fn, form):
            def record(*args):
                sides[(form, args[2])] += 1
                if frame[0] == CAPTURE_FRAME and keep is not None:
                    captured[keep].append(args)
                return fn(*args)
            return record

        def step(s, f):
            img, g, m, bk, lf = f
            s, out = vloam_step(s, img, g, m, ext, fcfg, pre_gridded=True, pre_buckets=bk,
                                pre_lf_table=lf)
            vo_states.append(s.vo)
            frame[0] += 1
            return s, out

        real_track = image_ops.lk_track_fb

        def track(*a, **k):
            curr, ok = real_track(*a, **k)
            tracks.append(ok.sum())              # read after the drive: no sync inside it
            return curr, ok

        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(
                brisk, "gather_patches_stack", recorder(patch_gather.gather_patches_stack, "stack")))
            for mod in (sift, akaze, orb):
                stack.enter_context(mock.patch.object(
                    mod, "gather_patches", recorder(patch_gather.gather_patches, "single")))
            stack.enter_context(mock.patch.object(image_ops, "lk_track_fb", track))
            state = init_vloam_state(fcfg, dev)
            first_vo = state.vo
            _, outs, frame_ms, per_frame, syncs = drive(step, state, dframes, counters)

        want_b2 = FAMILY_B2.get(desc, {})
        for i in range(len(dframes)):
            got = {name: per_frame[name][i] for name in counters}
            want = {"knn_pair": 4 if i else 0, "gn_lidar": 4 if i else 0, "gn_vo": 1,
                    "gather_patches": step_per_frame["gather_patches"][i] if klt else 0,
                    "gather_single": want_b2.get("single", 0),
                    "gather_stack": want_b2.get("stack", 0)}
            assert got == want, f"{case} frame {i}: launches {got}, want {want}"
        want_sides = {(form, FAMILY_P[desc]): n * len(dframes) for form, n in want_b2.items()}
        assert dict(sides) == want_sides, f"{case}: B2 calls by (form, P) {dict(sides)}"
        for i, out in enumerate(outs):
            for name, v in out._asdict().items():
                assert bool(torch.isfinite(v.to(torch.float32)).all()), \
                    f"{case} frame {i}: non-finite {name}"
        assert syncs.count <= desc_syncs.count, \
            f"{case}: {syncs.count} synchronising calls in frame {SYNC_FRAME}, phase 9 makes " \
            f"{desc_syncs.count} ({', '.join(syncs.sites)})"
        if klt:
            counts = [int(t) for t in tracks]
        else:   # the matches each frame's solve saw, recomputed from the rolled descriptors
            counts = [int(iu.match(p.prev_desc, p.prev_desc_mask, c.prev_desc, c.prev_desc_mask,
                                   matcher_type=matcher, select=fcfg.visual.match_select,
                                   ratio=fcfg.visual.match_ratio)[1].sum())
                      for p, c in zip([first_vo] + vo_states[:-1], vo_states)]
        print(f"  ({case}) B2 calls a frame by (form, P): "
              f"{ {k: v // len(dframes) for k, v in sides.items()} }; launches per frame: "
              f"{', '.join(f'{k} {v[:3]}...' for k, v in per_frame.items())}")
        print(f"    {'tracks' if klt else 'valid matches'} per frame: {counts} (fewest from frame "
              f"1: {min(counts[1:])}); keypoints on the last frame: "
              f"{int(vo_states[-1].prev_pts_mask.sum())}")
        _, lo_err, mo_err, path = check_lidar(outs, poses, case)
        vo_err = float(np.linalg.norm(outs[-1].world_vo[4:].cpu().numpy()
                                      - poses[len(outs) - 1][1]))
        print(f"    VO (not gated): final error {vo_err:.3f} m ({vo_err / path * 100:.2f} %) over "
              f"{path:.1f} m; MO {mo_err:.3f} m ({mo_err / path * 100:.2f} %)")
        print(f"    {ms_line(frame_ms, 5, card)}")
        print(f"    synchronising calls in frame {SYNC_FRAME}: {syncs.count} "
              f"({', '.join(syncs.sites)}); phase 9: {desc_syncs.count}"
              + (f"; other warnings: {syncs.other}" if syncs.other else ""))
        if desc in ("brisk", "freak"):
            launches["gather_patches_stack"] += patch_gather.LAUNCHES_STACK
        if desc == "sift":
            launches["gather_patches_single_p24"] += patch_gather.LAUNCHES_SINGLE
        del dframes, vo_states, outs
    return launches, captured


# ---- phase 15: the epipolar VO solvers and the map-sharded step -----------------------

SHARD_OUTPUTS = ("vo_pose", "lo_pose", "mo_pose", "world_mo")


def check_last_modules(cfg, ext, short, poses, card, step_per_frame, step_syncs, step_ms, graph):
    """Phase 15: (a) the epipolar solvers, (b) the sharded step at S = 1 over
    NCCL, (c) at S = 2 over gloo on the one card.  Returns the launches of
    the sharded runs {counter: n} (both ranks' in (c))."""
    from vloam_tpu_torch.models.vloam import frame_to_device

    print(f"== phase 15: the epipolar VO solvers and the map-sharded step, kitti_hdl64, "
          f"{len(short)} frames [{card}]")
    dev = torch.device("cuda", 0)
    dframes = [frame_to_device(*f, dev) for f in short]
    t0 = time.perf_counter()
    check_epipolar(cfg, ext, dframes, poses, card)
    print(f"  (a) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    outs, counts, launches = check_shard_one(cfg, ext, dframes, card, step_per_frame, step_syncs,
                                             step_ms)
    print(f"  (b) {time.perf_counter() - t0:.1f} s")
    del dframes
    fresh_device(dev)
    check_rebase_rows(dev)
    t0 = time.perf_counter()
    for name, n in check_shard_two(cfg, short, card, outs, counts, step_per_frame, graph,
                                   dev).items():
        launches[name] += n
    print(f"  (c) {time.perf_counter() - t0:.1f} s")
    return launches


def check_rebase_rows(dev):
    """Phase 15 (c) rests on one property of ``knn_pair``'s kernel: it
    rebases a problem to the centre of the box of its masked candidates,
    rows at or past the candidate count included, and lets no such row
    enter (``parallel/mapping_shard._window_box`` appends the window's box
    there).  Two problems with the same two candidates 24 m below the origin
    and queries on their bisector, one with a window's box corners past the
    count, one with a rank slice's: the kernel's d2 and indices must equal
    the plain version's bit for bit, and the two boxes must send some near
    ties different ways (a kernel that ignored the rows past the count
    would rebase both problems alike)."""
    from vloam_tpu_torch.ops import fused_knn

    rng = np.random.default_rng(3)
    a = torch.tensor([[3.71, -1.32, -24.6]])
    b = a + torch.tensor([[0.41, 0.23, -0.17]])
    mid, axis = (a + b) / 2, (b - a) / torch.linalg.norm(b - a)
    off = torch.tensor(rng.normal(0, 0.3, (REBASE_QUERIES, 3)), dtype=torch.float32)
    q = mid + off - axis * (off * axis).sum(1, keepdim=True)
    q = (q + axis * torch.tensor(rng.normal(0, 2e-6, (REBASE_QUERIES, 1)),
                                 dtype=torch.float32)).to(dev)
    window = torch.tensor([[-29.3717, -30.1291, -27.0443], [30.0107, 27.7703, -21.4977]])
    own = torch.tensor([[-49.1, -12.2, -27.5], [8.3, 40.0, -24.3]])
    cw, co = (torch.cat([a, b, box]).to(dev) for box in (window, own))
    mask = torch.ones(4, dtype=torch.bool, device=dev)
    args = (q, cw, mask, 5, q, co, mask, 5)
    kw = dict(a_counts=(None, 2), b_counts=(None, 2))
    got = fused_knn.knn_pair(*args, **kw)
    want = fused_knn.knn_pair_reference(*args, **kw)
    for (gd, gi), (wd, wi), box in zip(got, want, ("window", "own slice")):
        assert torch.equal(gd, wd) and torch.equal(gi, wi), \
            f"knn_pair with the {box}'s box past the count differs from its plain version"
    flips = int((got[0][1][:, 0] != got[1][1][:, 0]).sum())
    assert flips > 0, "the rows past the count did not move knn_pair's rebase centre"
    print(f"  (c0) knn_pair rebases to its masked rows' box, rows past the count included: "
          f"d2 and indices bit-equal to the plain version with a window's and a rank slice's "
          f"box past the count; {flips} of {REBASE_QUERIES} near ties go the other way between "
          f"the two centres")


def two_view(rng, n, yaw, t, outliers):
    """tests/test_epipolar.py's two views: a random scene seen from the
    identity and from (R, t), a quarter of the matches gross outliers if
    ``outliers``.  Returns (K, uv0, uv1, R, t) in float64."""
    K = np.array([[718.0, 0, 607.0], [0, 718.0, 185.0], [0, 0, 1.0]])
    X = np.stack([rng.uniform(-15, 15, n), rng.uniform(-3, 3, n), rng.uniform(6, 40, n)], -1)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    t = np.asarray(t, np.float64)
    X1 = X @ R.T + t
    uv0 = (X @ K.T)[:, :2] / (X @ K.T)[:, 2:3]
    uv1 = (X1 @ K.T)[:, :2] / (X1 @ K.T)[:, 2:3]
    if outliers:
        bad = rng.random(n) < 0.25
        uv1[bad] += rng.uniform(30, 80, (bad.sum(), 2))
    return K, uv0, uv1, R, t


def pose_errors(pose, R, t):
    """(max rotation-matrix entry error, translation direction cosine) of a
    pose against the rotation R and the translation direction t."""
    from vloam_tpu_torch import geometry as geo

    p = pose.detach().cpu().double()
    rot = float(np.abs(geo.quat_to_matrix(p[:4]).numpy() - R).max())
    est = p[4:].numpy()
    return rot, float(est @ t / (np.linalg.norm(est) * np.linalg.norm(t)))


def check_epipolar(cfg, ext, dframes, poses, card):
    """Phase 15 (a): ``solve_ransac`` and ``solve_nls_2d_only`` on the card,
    on the KLT tracks of frame TRACK_FRAME and on two-view cases."""
    from vloam_tpu_torch import geometry as geo
    from vloam_tpu_torch.models import frame_graph as fg
    from vloam_tpu_torch.models.visual_odometry import solve_nls_2d_only, solve_ransac
    from vloam_tpu_torch.models.vloam import init_vloam_state, vloam_step
    from vloam_tpu_torch.ops import epipolar, image_ops, threefry

    dev = dframes[0][0].device
    name = "lk_track_fb" if cfg.visual.klt_fb_check else "lk_track"
    real, tracks = getattr(image_ops, name), []

    def recorded(prev_img, img, prev_pts, prev_mask, *args, **kw):
        curr, ok = real(prev_img, img, prev_pts, prev_mask, *args, **kw)
        tracks.append((prev_pts, curr, ok & prev_mask))
        return curr, ok

    state = init_vloam_state(cfg, dev)
    with mock.patch.object(image_ops, name, recorded):
        for img, g, m, bk, lf in dframes[:TRACK_FRAME + 1]:
            state, _ = vloam_step(state, img, g, m, ext, cfg, pre_gridded=True, pre_buckets=bk,
                                  pre_lf_table=lf)
    del state
    # ground truth: the camera's motion cam0_curr_T_cam0_last from the sensor's
    R_rel, t_rel = gt_delta(poses, TRACK_FRAME)
    f32 = dict(dtype=torch.float32)
    gt = fg.lo_delta_to_cam0(geo.pose_from_qt(geo.matrix_to_quat(torch.tensor(R_rel, **f32)),
                                              torch.tensor(t_rel, **f32)),
                             fg.kitti_default_extrinsics("cpu")).double()
    R_gt, t_gt = geo.quat_to_matrix(gt[:4]).numpy(), gt[4:].numpy()
    rng = np.random.default_rng(0)
    K2, a0, a1, R2, t2 = two_view(rng, 1024, 0.02, (0.7, 0.05, 0.1), outliers=True)
    K3, b0, b1, R3, t3 = two_view(rng, 1024, 0.015, (0.8, 0.0, 0.05), outliers=False)
    on = lambda x: torch.tensor(x, device=dev, **f32)  # noqa: E731
    ones = torch.ones(1024, dtype=torch.bool, device=dev)
    prev_pts, curr_pts, ok = tracks[TRACK_FRAME]
    cases = [(f"KLT tracks of frame {TRACK_FRAME}", prev_pts, curr_pts, ok, ext.P_rect0[:, :3],
              R_gt, t_gt, None),
             ("two-view, 25 % outliers", on(a0), on(a1), ones, on(K2), R2, t2, None),
             ("two-view, seeded NLS", on(b0), on(b1), ones, on(K3), R3, t3,
              geo.pose_from_qt(geo.matrix_to_quat(on(R3)), on(t3 * 1.1)))]
    for label, uv0, uv1, mask, K, R, t, seed in cases:
        n_valid = int(mask.sum())
        assert n_valid >= 8, f"{label}: {n_valid} valid matches"
        # the samples: the NumPy threefry draw, selected on the host with a stable sort
        keys = threefry.gumbel_keys(0, N_HYPOTHESES, mask.shape[0])
        want = np.argsort(-np.where(mask.cpu().numpy()[None, :], keys, -1), axis=1,
                          kind="stable")[:, :threefry.N_SAMPLE]
        got = epipolar.ransac_samples(mask, N_HYPOTHESES, 0).cpu().numpy()
        assert np.array_equal(got, want), f"{label}: RANSAC samples differ from the NumPy draw"
        threefry._DEVICE_KEYS.clear()   # the first call below uploads its keys again
        with SyncCounter() as cold:
            pose, n_inl = solve_ransac(uv0, uv1, mask, K, N_HYPOTHESES)
        with SyncCounter() as warm:
            solve_ransac(uv0, uv1, mask, K, N_HYPOTHESES)
        ms = time_ms(lambda: solve_ransac(uv0, uv1, mask, K, N_HYPOTHESES))
        cpu_pose, cpu_n = solve_ransac(uv0.cpu(), uv1.cpu(), mask.cpu(), K.cpu(), N_HYPOTHESES)
        cpu_R = geo.quat_to_matrix(cpu_pose[:4].double()).numpy()
        vs_cpu = pose_errors(pose, cpu_R, cpu_pose[4:].double().numpy())
        vs_gt = pose_errors(pose, R, t)
        print(f"  {label}: {n_valid} valid matches, RANSAC samples ({N_HYPOTHESES}, 8) equal to the "
              f"NumPy threefry draw; solve_ransac {int(n_inl)} inliers (CPU {int(cpu_n)}), "
              f"rotation {vs_cpu[0]:.2e} / direction cos {vs_cpu[1]:.6f} from the CPU's pose, "
              f"{vs_gt[0]:.2e} / {vs_gt[1]:.6f} from the ground truth; {ms:.3f} ms a call "
              f"(CUDA events, median of {TIMING_RUNS}); synchronising calls a call: {warm.count} "
              f"({', '.join(warm.sites)}), {cold.count} on the call that uploads the keys [{card}]")
        assert vs_cpu[0] <= RANSAC_ROT_TOL and vs_cpu[1] >= RANSAC_COS_MIN, f"{label}: card vs CPU"
        assert vs_gt[0] <= RANSAC_ROT_TOL and vs_gt[1] >= RANSAC_COS_MIN, f"{label}: vs ground truth"
        if label.startswith("two-view, 25"):
            continue   # the 2D-only NLS has no outlier gate but Huber's: run where its test runs it
        nls_seed = pose if seed is None else seed
        with SyncCounter() as nls_syncs:
            nls = solve_nls_2d_only(uv0, uv1, mask, K, cfg, nls_seed)
        nls_ms = time_ms(lambda: solve_nls_2d_only(uv0, uv1, mask, K, cfg, nls_seed))
        cpu_nls = solve_nls_2d_only(uv0.cpu(), uv1.cpu(), mask.cpu(), K.cpu(), cfg, nls_seed.cpu())
        n_cpu = pose_errors(nls, geo.quat_to_matrix(cpu_nls[:4].double()).numpy(),
                            cpu_nls[4:].double().numpy())
        n_gt = pose_errors(nls, R, t)
        print(f"    solve_nls_2d_only from {'the RANSAC pose' if seed is None else 'near the truth'}: "
              f"rotation {n_cpu[0]:.2e} / direction cos {n_cpu[1]:.6f} from the CPU's pose, "
              f"{n_gt[0]:.2e} / {n_gt[1]:.6f} from the ground truth; {nls_ms:.3f} ms a call; "
              f"synchronising calls a call: {nls_syncs.count} [{card}]")
        assert n_cpu[0] <= NLS_ROT_TOL and n_cpu[1] >= NLS_COS_MIN, f"{label}: NLS card vs CPU"
        if seed is not None:
            assert n_gt[0] <= NLS_ROT_TOL and n_gt[1] >= NLS_COS_MIN, f"{label}: NLS vs truth"


def count_tol(n: int) -> int:
    return max(5, n // 200)


def lifted_state(cfg, dev, n_map_shards=1):
    """``init_vloam_state`` with the map lifted by ``SHARD_LIFT``."""
    from vloam_tpu_torch.models.vloam import init_vloam_state

    state = init_vloam_state(cfg, dev, n_map_shards=n_map_shards)
    lift = torch.tensor(SHARD_LIFT, dtype=torch.float32, device=dev)
    return state._replace(mp=state.mp._replace(wmap_wodom=lift))


def check_shard_one(cfg, ext, dframes, card, step_per_frame, step_syncs, step_ms):
    """Phase 15 (b): the sharded full step at S = 1 over NCCL, one rank in
    this process, beside the single-device step on the same frames, both
    from the lifted map with deterministic algorithms; then the single step
    with the default algorithms, to show their run-to-run spread.  Returns
    (the sharded outputs on the host, its map counts, its launches)."""
    from vloam_tpu_torch.models.vloam import vloam_step

    dev = dframes[0][0].device
    counters = launch_counters()

    def single(s, f):
        img, g, m, bk, lf = f
        return vloam_step(s, img, g, m, ext, cfg, pre_gridded=True, pre_buckets=bk, pre_lf_table=lf)

    fresh_device(dev)
    torch.use_deterministic_algorithms(True)
    try:
        ref_state, ref, ref_ms, ref_per, _ = drive(single, lifted_state(cfg, dev), dframes, counters)
        ref_counts = (int(ref_state.mp.corner_cnt.sum()), int(ref_state.mp.surf_cnt.sum()))
        del ref_state
        fresh_device(dev)
        outs, counts, launches, per, frame_ms, syncs, backend = shard_one_drive(
            cfg, ext, dframes, counters)
    finally:
        torch.use_deterministic_algorithms(False)
    _, free, _, _, _ = drive(single, lifted_state(cfg, dev), dframes, counters)
    spread = max(float((getattr(o, k) - getattr(r, k)).abs().max())
                 for o, r in zip(free, ref) for k in SHARD_OUTPUTS)
    assert backend == "nccl", backend
    assert per == ref_per, f"sharded launches a frame {per}, single-device {ref_per}"
    for i in range(1, len(dframes)):
        assert (per["knn_pair"][i], per["gn_lidar"][i]) == (4, 4), (i, per)
    worst = max(float((getattr(o, k) - getattr(r, k)).abs().max())
                for o, r in zip(outs, ref) for k in SHARD_OUTPUTS)
    assert worst <= SHARD_TOL, f"S = 1 outputs {worst} from the single-device step's"
    for got, want, what in zip(counts, ref_counts, ("corner", "surf")):
        assert abs(got - want) <= count_tol(want), f"S = 1 {what} points {got}, single {want}"
    print(f"  (b) S = 1 over NCCL (backend {backend}), {len(dframes)} frames from the map lifted "
          f"{-SHARD_LIFT[6]:g} m, deterministic algorithms: {', '.join(SHARD_OUTPUTS)} within "
          f"{worst:.2e} of the single-device step's in the same mode (bound {SHARD_TOL}); map "
          f"{counts[0]} corner + {counts[1]} surf points, single-device {ref_counts[0]} + "
          f"{ref_counts[1]}; launches a frame equal the single step's: "
          f"{', '.join(f'{k} {v[:3]}...' for k, v in per.items())}")
    print(f"    the single step with the default algorithms: {spread:.2e} from it (float atomics, "
          f"ROADMAP C-b)")
    print(f"    sharded {ms_line(frame_ms, 5, card)}")
    print(f"    single-device step on the same frames, same mode: {ms_line(ref_ms, 5, card)}; "
          f"phase 5's median (default algorithms) {step_ms:.3f} ms/frame")
    print(f"    synchronising calls in frame {SYNC_FRAME}: {syncs.count} ({', '.join(syncs.sites)}); "
          f"phase 5's step {step_syncs.count}")
    host = [{k: getattr(o, k).cpu() for k in SHARD_OUTPUTS} for o in outs]
    return host, counts, launches


def shard_one_drive(cfg, ext, dframes, counters):
    """The sharded full step at S = 1 over NCCL, one rank in this process,
    from the lifted map: (outputs, map counts, launches, launches a frame,
    ms a frame, the synchronising calls of SYNC_FRAME, the backend)."""
    import datetime

    import torch.distributed as dist
    from vloam_tpu_torch.parallel import mesh as pmesh
    from vloam_tpu_torch.parallel.vloam_shard import make_sharded_vloam_step, shard_vloam_state

    dev = dframes[0][0].device
    with tempfile.TemporaryDirectory() as tmp:
        pmesh.init_distributed("nccl", f"file://{tmp}/store", 1, 0,
                               timeout=datetime.timedelta(seconds=SHARD_TIMEOUT))
        try:
            mesh = pmesh.map_mesh(1, device=dev)
            step = make_sharded_vloam_step(cfg, ext, mesh)

            def sharded(s, f):
                img, g, m, bk, lf = f
                return step(s, img, g, m, pre_gridded=True, pre_buckets=bk, pre_lf_table=lf)

            before = {name: get() for name, get in counters.items()}
            state = shard_vloam_state(lifted_state(cfg, dev), mesh)
            state, outs, frame_ms, per, syncs = drive(sharded, state, dframes, counters)
            launches = {name: get() - before[name] for name, get in counters.items()}
            counts = (int(state.mp.corner_cnt.sum()), int(state.mp.surf_cnt.sum()))
            backend = dist.get_backend()
            del state
        finally:
            dist.destroy_process_group()
    return outs, counts, launches, per, frame_ms, syncs, backend


def split_factors(factors, S):
    """S blocks of the factors, the last padded with invalid ones."""
    from vloam_tpu_torch.parallel.pose_graph import PoseGraphFactors

    F = factors.i.shape[0]
    n = -(-F // S)
    pad = n * S - F
    full = PoseGraphFactors(*(torch.cat([x, torch.zeros((pad,) + x.shape[1:], dtype=x.dtype,
                                                        device=x.device)]) for x in factors))
    return [PoseGraphFactors(*(x[r * n:(r + 1) * n].cpu() for x in full)) for r in range(S)]


def check_shard_two(cfg, short, card, ref_outs, ref_counts, step_per_frame, graph, dev):
    """Phase 15 (c): two ranks on the one card.  NCCL's answer to two ranks
    on one device first, then the sharded step over gloo (CUDA tensors
    copied through host memory) in two spawned processes, from the lifted
    map with deterministic algorithms, as (b).  Returns both ranks'
    launches."""
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.models.laser_mapping import n_cubes
    from vloam_tpu_torch.parallel.mapping_shard import merge_payload_bytes
    from vloam_tpu_torch.parallel.mesh import run_ranks
    from vloam_tpu_torch.parallel.pose_graph import concat_factors, optimize_pose_graph

    S = 2
    assert kernels.library_path().exists(), "phase 2 builds the kernels; the ranks only load them"
    with tempfile.TemporaryDirectory() as tmp:
        probe = os.path.join(tmp, "nccl")
        os.makedirs(probe)
        torch.save(dict(job="nccl_probe"), os.path.join(probe, "payload.pt"))
        try:
            run_ranks(shard_rank, S, args=(S, "nccl", probe), timeout=120.0)
            notes = sorted({torch.load(os.path.join(probe, f"rank{r}.pt"), weights_only=False)
                            for r in range(S)})
        except Exception as e:  # noqa: BLE001  (a rank that died or hung is the answer too)
            notes = [f"{type(e).__name__}: {str(e).strip().splitlines()[-1][:300]}"]
        print(f"  (c) NCCL with two ranks on cuda:0: {' | '.join(notes)}")

        loop = graph["loop"]
        factors = graph["chain"] if loop is None else concat_factors(graph["chain"], loop)
        pg_poses = graph["poses"].to(torch.float32)
        run = os.path.join(tmp, "gloo")
        os.makedirs(run)
        torch.save(dict(job="vloam", cfg=cfg, frames=short, pg_poses=pg_poses.cpu(),
                        pg_factors=split_factors(factors, S)), os.path.join(run, "payload.pt"))
        t0 = time.perf_counter()
        run_ranks(shard_rank, S, args=(S, "gloo", run), timeout=SHARD_TIMEOUT)
        wall = time.perf_counter() - t0
        res = [torch.load(os.path.join(run, f"rank{r}.pt"), weights_only=False) for r in range(S)]
    mc = cfg.mapping
    want_merge = mc.outer_iters * (merge_payload_bytes(S, mc.corner_stack_cap, mc.n_neighbors)
                                   + merge_payload_bytes(S, mc.surf_stack_cap, mc.n_neighbors))
    worst, ranks_apart, holding = 0.0, 0.0, 0
    for r in res:
        for i, (o, ref) in enumerate(zip(r["outs"], ref_outs)):
            for k in SHARD_OUTPUTS:
                worst = max(worst, float((o[k] - ref[k]).abs().max()))
                ranks_apart = max(ranks_apart, float((o[k] - res[0]["outs"][i][k]).abs().max()))
        per = {k: v for k, v in r["per_frame"].items()}
        want_per = {k: v[:len(short)] for k, v in step_per_frame.items()}
        assert per == want_per, f"rank launches a frame {per}, phase 5's {want_per}"
        assert r["merge"][0] == 0 and all(b == want_merge for b in r["merge"][1:]), \
            f"merge bytes a frame {r['merge']}, want {want_merge} from frame 1"
        assert r["cube_rows"] == -(-n_cubes(cfg) // S) + 1, r["cube_rows"]
        holding += sum(r["counts"]) > 0 and sum(r["window"]) > 0
    assert worst <= SHARD_TOL, f"S = 2 outputs {worst} from (b)'s"
    assert ranks_apart <= RANKS_APART_TOL, f"the ranks' outputs {ranks_apart} apart"
    assert holding == S, (f"{holding} of the {S} ranks hold map points in their window: the "
                          f"merge joined no candidates of another rank")
    counts = [sum(r["counts"][j] for r in res) for j in range(2)]
    for got, want, what in zip(counts, ref_counts, ("corner", "surf")):
        assert abs(got - want) <= count_tol(want), f"S = 2 {what} points {got}, S = 1 {want}"
    single_pg = optimize_pose_graph(pg_poses.to(dev), type(factors)(*(x.to(dev) for x in factors)),
                                    iters=4).cpu()
    pg_err = max(float((r["pg"] - single_pg).abs().max()) for r in res)
    assert pg_err <= PG_SHARD_TOL, f"sharded pose graph {pg_err} from the unsharded solve"
    ms = [statistics.median(r["ms"][5:]) for r in res]
    print(f"  (c) S = 2 over gloo, both ranks on cuda:0, {len(short)} frames, the lifted map, "
          f"deterministic algorithms: {', '.join(SHARD_OUTPUTS)} "
          f"within {worst:.2e} of (b)'s (bound {SHARD_TOL}), ranks {ranks_apart:.2e} apart (bound "
          f"{RANKS_APART_TOL}); {holding} of {S} ranks hold points in their window; map "
          f"{counts[0]} corner + {counts[1]} surf points summed over the ranks, (b) {ref_counts[0]} + "
          f"{ref_counts[1]}; launches a frame on each rank equal phase 5's")
    for r, x in enumerate(res):
        print(f"    rank {r}: cube array {x['cube_rows']} slots, {x['cube_bytes'] / 2**20:.0f} MiB "
              f"(one rank's block; the unsharded map holds {n_cubes(cfg) + 1} slots), "
              f"{x['counts'][0]} + {x['counts'][1]} points, window cache {x['window'][0]} + "
              f"{x['window'][1]}; merge bytes a frame {x['merge'][1]} = "
              f"merge_payload_bytes(2, M, {mc.n_neighbors}) x 2 feature types x {mc.outer_iters} "
              f"outer iterations; gloo and CUDA tensors: {x['cuda_ops']}")
    print(f"    phase 10's pose graph ({pg_poses.shape[0]} poses, {factors.i.shape[0]} factors) "
          f"split over the 2 ranks: within {pg_err:.2e} of the unsharded solve (bound "
          f"{PG_SHARD_TOL})")
    print(f"    transport: gloo through host memory (every collective copies its CUDA tensors to "
          f"the host and back); ms/frame median (frames 5..{len(short) - 1}, host clock, "
          f"synchronised) rank 0 {ms[0]:.3f}, rank 1 {ms[1]:.3f}: two ranks sharing one card "
          f"and a host transport, not a multi-GPU number; both ranks' run {wall:.1f} s with "
          f"start-up [{card}]")
    return {k: sum(sum(r["per_frame"][k]) for r in res) for k in res[0]["per_frame"]}


def shard_rank(rank, S, backend, workdir):
    """One rank of phase 15 (c), in a spawned process on cuda:0: joins the
    process group through the file store in ``workdir``, runs the job of
    ``workdir/payload.pt`` and writes ``workdir/rank<r>.pt``."""
    import datetime

    import torch.distributed as dist
    from vloam_tpu_torch.parallel import mesh as pmesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    p = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    pmesh.init_distributed(backend, f"file://{workdir}/store", S, rank,
                           timeout=datetime.timedelta(seconds=SHARD_TIMEOUT))
    if p["job"] == "nccl_probe":
        try:
            x = torch.ones(1, device=dev)
            dist.all_reduce(x)
            torch.cuda.synchronize()
            note = f"an all_reduce ran (sum {float(x)})"
        except Exception as e:  # noqa: BLE001  (the refusal is what this job reports)
            note = f"refused: {type(e).__name__}: {str(e).strip().splitlines()[0][:300]}"
        torch.save(note, os.path.join(workdir, f"rank{rank}.pt"))
        os._exit(0)   # leave the refused communicator to the process's end
    try:
        torch.save(shard_drive(S, dev, p), os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def shard_drive(S, dev, p):
    """The sharded full step on this rank over the payload's frames, then
    this rank's block of the pose-graph factors."""
    import torch.distributed as dist
    from vloam_tpu_torch import kernels
    from vloam_tpu_torch.models.frame_graph import kitti_default_extrinsics
    from vloam_tpu_torch.models.vloam import frame_to_device
    from vloam_tpu_torch.parallel import mapping_shard, mesh as pmesh
    from vloam_tpu_torch.parallel.pose_graph import optimize_pose_graph
    from vloam_tpu_torch.parallel.vloam_shard import make_sharded_vloam_step, shard_vloam_state

    assert kernels.library_path().exists(), "the parent builds the kernels before the ranks start"
    kernels.lib()
    cfg = p["cfg"]
    torch.use_deterministic_algorithms(True)   # as (b), whose outputs these are held to
    mesh = pmesh.map_mesh(S, device=dev)
    cuda_ops = {}
    for name, op in (("all_reduce", lambda t: dist.all_reduce(t)),
                     ("all_gather", lambda t: dist.all_gather([torch.empty_like(t)
                                                               for _ in range(S)], t))):
        try:
            op(torch.ones(4, device=dev))
            torch.cuda.synchronize()
            cuda_ops[name] = "takes them"
        except Exception as e:  # noqa: BLE001  (which collectives refuse is what is recorded)
            cuda_ops[name] = f"refuses them ({type(e).__name__}: {str(e).strip().splitlines()[0][:80]})"
    ext = kitti_default_extrinsics(dev)
    frames = [frame_to_device(*f, dev) for f in p["frames"]]
    state = shard_vloam_state(lifted_state(cfg, dev, n_map_shards=S), mesh)
    torch.cuda.empty_cache()
    step = make_sharded_vloam_step(cfg, ext, mesh)
    counters = launch_counters()
    per = {name: [] for name in counters}
    merge, ms, outs = [], [], []
    for img, g, m, bk, lf in frames:
        before = {name: get() for name, get in counters.items()}
        merged = mapping_shard.MERGE_BYTES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = step(state, img, g, m, pre_gridded=True, pre_buckets=bk, pre_lf_table=lf)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for name, get in counters.items():
            per[name].append(get() - before[name])
        merge.append(mapping_shard.MERGE_BYTES - merged)
        outs.append({k: getattr(out, k).cpu() for k in SHARD_OUTPUTS})
    mp = state.mp
    factors = p["pg_factors"][mesh.rank]
    pg = optimize_pose_graph(p["pg_poses"].to(dev), type(factors)(*(x.to(dev) for x in factors)),
                             iters=4, group=mesh)
    return dict(outs=outs, per_frame=per, merge=merge, ms=ms, cuda_ops=cuda_ops,
                cube_rows=mp.cube_pts.shape[0], cube_bytes=mp.cube_pts.numel() * 4,
                counts=(int(mp.corner_cnt.sum()), int(mp.surf_cnt.sum())),
                window=(int(mp.sub_c_n.sum()), int(mp.sub_s_n.sum())), pg=pg.cpu())


# ---- phase 16: the system-level drives and ops/cellhash ----------------------------------

def drive_counters():
    """Launch counters of every kernel the drives run."""
    from vloam_tpu_torch.ops import fused_gn, knn

    return {**launch_counters(), "gn_lidar_batched": lambda: fused_gn.LAUNCHES_BATCHED,
            "knn": lambda: knn.LAUNCHES}


def counted(fn):
    """fn() and the launches it made {counter: n}."""
    counters = drive_counters()
    before = {name: get() for name, get in counters.items()}
    out = fn()
    torch.cuda.synchronize()
    return out, {name: get() - before[name] for name, get in counters.items()}


def check_drives(cfg, card):
    """Phase 16: ``ops/cellhash`` against the brute k-NN, the loop drive at
    two laps, and the two coupling scenarios, each through its tool's
    function on the card.  Returns the drives' launches {counter: n}."""
    print(f"== phase 16: the system-level drives (tools.loop_drive, tools.coupling_scenarios) and "
          f"ops.cellhash, kitti_hdl64 [{card}]")
    t0 = time.perf_counter()
    check_cellhash(card)
    print(f"  cellhash {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = check_loop_drive(cfg, card)
    print(f"  loop drive {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for name, n in check_scenarios(cfg, card).items():
        launches[name] += n
    print(f"  scenarios {time.perf_counter() - t0:.1f} s")
    return launches


def check_cellhash(card):
    """``cell_knn`` on a scan of the street against the exact k-NN
    (``knn_reference``) of the points its table kept (a full bucket drops
    the rest, by design) within the 1 m gate, and what its two steps and the
    brute search cost on the card."""
    from vloam_tpu_torch.data import synthetic
    from vloam_tpu_torch.ops import cellhash, knn

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(8)
    # a map of the street: four scans along phase 2's course in the world frame, one point a
    # 0.4 m voxel (the map's plane resolution); the queries are other scan points, jittered
    scans = [synthetic.simulate_scan(R, t, synthetic.default_scene(), n_azimuth=1800,
                                     noise=0.005, seed=i) @ R.T + t
             for i, (R, t) in enumerate(synthetic.straight_trajectory(
                 40, speed=SPEED, yaw_rate=YAW_RATE)[::10])]
    world = np.concatenate(scans)
    _, first = np.unique(np.floor(world / 0.4).astype(np.int64), axis=0, return_index=True)
    voxels = world[rng.permutation(first)[:CELL_CANDS]]
    cand = torch.tensor(np.concatenate([voxels, np.ones((len(voxels), 1))], 1),
                        dtype=torch.float32, device=dev)
    q = torch.tensor(world[rng.integers(0, len(world), CELL_QUERIES)]
                     + rng.normal(0, 0.05, (CELL_QUERIES, 3)), dtype=torch.float32, device=dev)
    mask = torch.ones(cand.shape[0], dtype=torch.bool, device=dev)
    tbl, cnt = cellhash.build_cell_table(cand, mask, 1.0, CELL_TABLE, CELL_CAP)
    # the table grown in two appends, from an empty table on the card, is the one built at once
    grown = cellhash.empty_cell_table(CELL_TABLE, CELL_CAP, dev), torch.zeros_like(cnt)
    for part in (slice(0, cand.shape[0] // 2), slice(cand.shape[0] // 2, None)):
        grown = cellhash.append_cell_table(*grown, cand[part], mask[part], 1.0)
    assert torch.equal(grown[0], tbl) and torch.equal(grown[1], cnt), \
        "append_cell_table from an empty table differs from build_cell_table"
    d2, nbr = cellhash.cell_knn(q, tbl, 1.0, CELL_K)
    rows = tbl.reshape(-1, 4)
    kept = rows[rows[:, 0] < cellhash.SENTINEL, :3]
    assert kept.shape[0] == int(cnt.sum())
    ref, _ = knn.knn_reference(q, kept, torch.ones(kept.shape[0], dtype=torch.bool, device=dev),
                               CELL_K)
    inside = ref < 1.0
    worst = float(((d2 - ref).abs() - CELL_D2_RTOL * ref)[inside].max())
    close = d2 < 1.0
    re = ((nbr - q[:, None, :]) ** 2).sum(-1)
    worst_re = float(((re - d2).abs() - CELL_D2_RTOL * d2)[close].max())
    ms = {"build_cell_table": time_ms(lambda: cellhash.build_cell_table(cand, mask, 1.0,
                                                                        CELL_TABLE, CELL_CAP)),
          "cell_knn": time_ms(lambda: cellhash.cell_knn(q, tbl, 1.0, CELL_K)),
          "knn_reference (plain, exact)": time_ms(lambda: knn.knn_reference(q, cand[:, :3], mask,
                                                                            CELL_K)),
          "knn (B5 kernel)": time_ms(lambda: knn.knn(q, cand[:, :3], mask, CELL_K))}
    print(f"  cell_knn ({CELL_QUERIES} queries, {cand.shape[0]} candidates, the street's map at "
          f"0.4 m, table {CELL_TABLE} x {CELL_CAP}: {kept.shape[0]} kept, "
          f"{cand.shape[0] - kept.shape[0]} dropped "
          f"by full buckets, the same table when grown by two appends from an empty one; "
          f"k={CELL_K}): {int(inside.sum())} of {inside.numel()} exact "
          f"neighbours among the kept points lie inside the 1 m gate, each found (|d2 - exact| - "
          f"{CELL_D2_RTOL} d2 at most {worst:.2e}, bound {CELL_D2_ATOL}); its neighbours "
          f"reproduce their d2 (at most {worst_re:.2e}); ms a call (CUDA events, median of "
          f"{TIMING_RUNS}): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" [{card}]")
    assert int(inside.sum()) > CELL_QUERIES, "too few neighbours inside the gate to compare"
    assert worst <= CELL_D2_ATOL, f"cell_knn misses a neighbour inside the gate: {worst}"
    assert worst_re <= CELL_D2_ATOL, f"cell_knn's neighbours disagree with its d2: {worst_re}"


def check_loop_drive(cfg, card):
    """``tools.loop_drive.drive`` over two laps of a ring: finite poses, a
    loop factor, the drift-scaled gate detecting at least what the fixed
    one does, and the refinement report.  Returns its launches."""
    from vloam_tpu_torch.tools import loop_drive

    rec, launches = counted(lambda: loop_drive.drive(cfg, LOOP_FRAMES, LOOP_LAPS, device="cuda",
                                                     verbose=False))
    print(f"  loop drive, {LOOP_FRAMES} frames, {LOOP_LAPS} laps ({rec['path_len_m']} m): "
          f"{json.dumps(rec)} [{card}]")
    print(f"    seconds: raycast on the host {rec['frame_gen_s']}, driver frames "
          f"{rec['process_s']}, close() {rec['close_s']}; launches {launches}")
    report = rec["refine_report"]
    finite = [rec[k] for k in ("raw_ate_m", "raw_final_err_m", "refined_ate_m",
                               "refined_final_err_m")]
    assert all(v is not None and np.isfinite(v) for v in finite), rec
    assert report.get("loop_factors", 0) >= 1, f"no loop factor accepted: {report}"
    assert rec["detections_drift_scaled_gate"] >= rec["detections_fixed_gate"], rec
    for name in ("knn_pair", "gn_lidar", "gn_lidar_batched", "knn"):
        assert launches[name] > 0, f"loop drive: {name} not launched"
    return launches


def check_scenarios(cfg, card):
    """``tools.coupling_scenarios``' corridor and highway at the small-scale
    contracts' lengths: coupled wins in the corridor and loses on the
    highway.  Returns their launches."""
    from vloam_tpu_torch.tools import coupling_scenarios as cs

    res, launches = counted(lambda: {
        "corridor": cs.corridor(cfg, CORRIDOR_FRAMES, device="cuda"),
        "highway": cs.highway(cfg, HIGHWAY_FRAMES, device="cuda")})
    print(f"  scenarios: {json.dumps(res)}; launches {launches} [{card}]")
    cor, hwy = res["corridor"], res["highway"]
    assert cor["coupled_C"]["final_err_m"] < cor["decoupled_D"]["final_err_m"], cor
    assert hwy["coupled_C"]["final_err_pct"] > hwy["decoupled_D"]["final_err_pct"], hwy
    for name in ("knn_pair", "gn_lidar", "gn_vo", "gather_patches"):
        assert launches[name] > 0, f"scenarios: {name} not launched"
    return launches


if __name__ == "__main__":
    sys.exit(main())
