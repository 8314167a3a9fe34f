"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--control 1]

For each seed, makes the cell's drive as a run does and replays its judged
frames through:

- the plain reference in float32 with TF32 off, as the configuration states;
- the program, sound (``VloamDriver.process``, a fresh driver, as the
  window's first driver): the lower readings;
- the program with a fault planted underneath (``FAULTS``): the map left as
  the first frame made it; B1 handing MO a wrong neighbour; B1 handing LO
  its second nearest candidate as the nearest;
- with ``--control 1``, the plain reference with TF32 on, the nearest
  precision below the configuration's: the precision control.

and prints one JSON line a seed: each variant's numbers against the float32
reference (``judge.gaps``).  ``benchmark/tests/test_bench_control.py``
holds the control and the faults above the cell's limits on a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]


@contextlib.contextmanager
def map_unchanged():
    """MO inserts nothing after the first frame: the map stays as frame 0
    made it."""
    from vloam_tpu_torch.models import laser_mapping as lm
    real, calls = lm._scatter_insert_pair, [0]

    def insert(corner_w, c_mask, surf_w, s_mask, *a, **kw):
        calls[0] += 1
        if calls[0] > 1:
            c_mask, s_mask = c_mask & False, s_mask & False
        return real(corner_w, c_mask, surf_w, s_mask, *a, **kw)
    with mock.patch.object(lm, "_scatter_insert_pair", insert):
        yield


@contextlib.contextmanager
def wrong_neighbour():
    """B1 as MO calls it hands back, for every query, its nearest map point
    in place of its farthest of the k: one neighbour wrong, the answer
    altered where it is produced."""
    from vloam_tpu_torch.models import laser_mapping as lm
    real = lm.knn_pair

    def knn_pair(*a, **kw):
        (d2a, ia), (d2b, ib) = real(*a, **kw)
        ia, ib = ia.clone(), ib.clone()
        ia[:, -1], ib[:, -1] = ia[:, 0], ib[:, 0]
        d2a, d2b = d2a.clone(), d2b.clone()
        d2a[:, -1], d2b[:, -1] = d2a[:, 0], d2b[:, 0]
        return (d2a, ia), (d2b, ib)
    with mock.patch.object(lm, "knn_pair", knn_pair):
        yield


@contextlib.contextmanager
def lo_wrong_neighbour():
    """B1 as LO calls it hands back, for every query, its second nearest
    candidate as its nearest."""
    from vloam_tpu_torch.models import lidar_odometry as lo
    real = lo.knn_pair

    def knn_pair(*a, **kw):
        (d2a, ia), (d2b, ib) = real(*a, **kw)
        ia, ib, d2a, d2b = ia.clone(), ib.clone(), d2a.clone(), d2b.clone()
        ia[:, 0], ib[:, 0], d2a[:, 0], d2b[:, 0] = ia[:, 1], ib[:, 1], d2a[:, 1], d2b[:, 1]
        return (d2a, ia), (d2b, ib)
    with mock.patch.object(lo, "knn_pair", knn_pair):
        yield


FAULTS = {"map_unchanged": map_unchanged, "wrong_neighbour": wrong_neighbour,
          "lo_wrong_neighbour": lo_wrong_neighbour}


def program_rows(cfg, frames: list, device) -> dict:
    """The program's exported rows {chain: (n, 3, 4)} of ``frames`` through
    one fresh ``VloamDriver``."""
    from vloam_tpu_torch.models import frame_graph as fg
    from vloam_tpu_torch.runtime.driver import VloamDriver
    from vbench import judge

    tmp = tempfile.mkdtemp(prefix="vbench-control-")
    try:
        drv = VloamDriver(cfg, fg.kitti_default_extrinsics(device), out_dir=tmp, device=device)
        for img, cloud in frames:
            drv.process(img, cloud)
        drv.close()
        return judge.read_rows(tmp, int(cfg.detach_vo_lo))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def readings(cell, seed: int, device, control: bool = False, faults=tuple(FAULTS)) -> dict:
    """{"seed", "<variant>": {number: value}, "seconds"} of one seed."""
    import numpy as np

    import plainref.config as ref_config
    import vloam_tpu_torch.config as port_config
    from plainref.models import frame_graph as ref_fg
    from vbench import judge, spec, traffic

    tr = cell.traffic
    judged = tr["judged_frames"]
    ref_cfg = spec.build_config(ref_config, cell.config["vloam"])
    cfg = spec.build_config(port_config, cell.config["vloam"])
    K = ref_fg.kitti_default_extrinsics("cpu").P_rect0[:, :3].numpy().astype(np.float64)
    frames, _ = traffic.make_drive(tr, cfg.visual.img_height, cfg.visual.img_width, K, seed, 0,
                                   device, n_frames=judged)
    out, secs = {"seed": seed}, {}
    t = time.perf_counter()
    f32 = judge.reference_rows(ref_cfg, frames, judged, device)
    secs["reference"] = time.perf_counter() - t

    def judge_rows(name, rows):
        numbers, problems = judge.gaps(rows, f32, judged)
        out[name] = dict(numbers, problems=problems,
                         frames=judge.frame_gaps(rows, f32, judged))

    t = time.perf_counter()
    judge_rows("program", program_rows(cfg, frames, device))
    secs["program"] = time.perf_counter() - t
    for name in faults:
        with FAULTS[name]():
            judge_rows(name, program_rows(cfg, frames, device))
    if control:
        t = time.perf_counter()
        judge_rows("tf32", judge.reference_rows(ref_cfg, frames, judged, device, tf32=True))
        secs["tf32"] = time.perf_counter() - t
    out["seconds"] = secs
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--faults", nargs="*", choices=sorted(FAULTS), default=sorted(FAULTS),
                    help="the faults to plant (default: all)")
    args = ap.parse_args(argv)
    import torch
    from vbench import spec
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    for seed in args.seeds:
        got = readings(cell, seed, "cuda:0", bool(args.control), tuple(args.faults))
        print(json.dumps({"workload": args.workload, "limits": cell.limits, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
