"""Run-to-run spread of the system drives on the card (ROADMAP C-i).  Run
from the repo root on a machine with one GPU:

    env PYTHONPATH=. python3 tests/torch_drive_spread.py [--coupling-runs 3] [--loop-runs 2]
        [--out FILE]

The card's float atomics move a few map inserts from run to run (ROADMAP
C-b), so two runs of one drive over the same frames are two samples of its
chain.  This script draws the lidar scans of ``tools.coupling_drive`` (its
defaults) and of ``tools.loop_drive`` (1 lap, ``--exclude-unreliable``, the
JAX record's scan noise 0.005 and drift rate 0.05) once, on all host cores,
then runs each tool's own ``drive`` several times over them (its raycasts
answered from the cache, keyed by every argument), and prints every run's
record and the spread of the numbers that PERF.md holds against the JAX
package's records.  It first runs ``chip_smoke.check_rebase_rows``.  With
``--out`` every run's record and the summary also go to FILE.  No tier-1
test: it needs the card.
"""

import argparse
import dataclasses
import hashlib
import json
import multiprocessing
import os
import time

import numpy as np
import torch

from vloam_tpu_torch.data import synthetic

CACHE = {}
MISSES = {"simulate_scan": 0, "raycast_camera": 0, "render_blob_image": 0}
ORIGINAL = {name: getattr(synthetic, name) for name in MISSES}


def key(name, *arrays, **kw):
    h = hashlib.sha1(name.encode())
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(repr(sorted(kw.items())).encode())
    return h.hexdigest()


def cached(name):
    def fn(*args, **kw):
        k = key(name, *args, **kw)
        if k not in CACHE:
            MISSES[name] += 1
            CACHE[k] = ORIGINAL[name](*args, **kw)
        return CACHE[k].copy() if isinstance(CACHE[k], np.ndarray) else CACHE[k]
    return fn


def scan(job):
    R, t, boxes, kw = job
    return key("simulate_scan", R, t, boxes, **kw), ORIGINAL["simulate_scan"](R, t, boxes, **kw)


def scan_jobs(poses, world, noise):
    """The tools' own scan calls: the world within 110 m of the sensor."""
    centers = (world[:, :3] + world[:, 3:]) / 2.0
    return [(R, t, world[np.linalg.norm(centers[:, :2] - t[:2], axis=1) < 110.0],
             dict(n_azimuth=900, noise=noise, seed=i)) for i, (R, t) in enumerate(poses)]


def prefetch(jobs):
    t0 = time.perf_counter()
    with multiprocessing.get_context("fork").Pool(os.cpu_count()) as pool:
        for k, cloud in pool.imap(scan, jobs, chunksize=8):
            CACHE[k] = cloud
    print(f"  {len(jobs)} scans on {os.cpu_count()} host cores in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def spread(values):
    return {"runs": values, "min": min(values, default=None), "max": max(values, default=None)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coupling-runs", type=int, default=3)
    ap.add_argument("--loop-runs", type=int, default=2)
    ap.add_argument("--out", default=None, help="write the records and the summary here")
    args = ap.parse_args()

    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.tools import coupling_drive, loop_drive

    # the scans, before this process touches the card (the pool forks)
    poses_c = synthetic.turns_trajectory(400, speed=1.1, straight=60, turn_frames=12)
    jobs = scan_jobs(poses_c, coupling_drive.route_world(poses_c), 0.01)
    n, speed = 1500, 1.3
    radius = speed / (2 * np.pi / n)
    jobs += scan_jobs(synthetic.straight_trajectory(n, speed=speed, yaw_rate=2 * np.pi / n),
                      loop_drive.ring_world(radius), 0.005)
    prefetch(jobs)
    for name in MISSES:
        setattr(synthetic, name, cached(name))

    import chip_smoke as cs

    print(f"[{cs.card_line()}]", flush=True)
    cs.check_rebase_rows(torch.device("cuda", 0))

    out = {"card": cs.card_line(), "coupling": [], "loop_excl": []}
    for r in range(args.coupling_runs):
        t0 = time.perf_counter()
        rec = coupling_drive.drive(kitti_hdl64(), device="cuda")
        out["coupling"].append(rec)
        print(f"coupling run {r}: {time.perf_counter() - t0:.1f} s {json.dumps(rec)}",
              flush=True)
    cfg = kitti_hdl64()
    cfg = cfg.replace(scan=dataclasses.replace(cfg.scan, exclude_unreliable=True))
    for r in range(args.loop_runs):
        t0 = time.perf_counter()
        rec = loop_drive.drive(cfg, n, 1, speed, 0.005, 900, 10, 0.05, device="cuda",
                               verbose=False)
        out["loop_excl"].append(rec)
        print(f"loop run {r}: {time.perf_counter() - t0:.1f} s {json.dumps(rec)}", flush=True)

    modes = {m: [rec[f"coupling_production_{m}"]["mo_trans_pct"] for rec in out["coupling"]]
             for m in ("decoupled_D", "coupled_C")}
    summary = {
        "coupling_mo_trans_pct": {m: spread(v) for m, v in modes.items()},
        "coupling_C_minus_D": spread([round(c - d, 4) for c, d in
                                      zip(modes["coupled_C"], modes["decoupled_D"])]),
        **{f"loop_excl_{k}": spread([rec[k] for rec in out["loop_excl"]])
           for k in ("drift_at_revisit_m", "raw_ate_m", "refined_ate_m", "refined_final_err_m",
                     "detections_drift_scaled_gate")},
        "loop_excl_heldout_refined_m": spread([round(rec["refine_report"]["heldout_refined_m"], 3)
                                               for rec in out["loop_excl"]]),
        "cache_misses": MISSES,
    }
    out["summary"] = summary
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
