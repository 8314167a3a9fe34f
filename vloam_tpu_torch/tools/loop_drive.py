"""Loop closure at drift scale: a multi-km ring course through the driver.

    python -m vloam_tpu_torch.tools.loop_drive [--frames 1500] [--laps 1] [--speed 1.3]
        [--noise 0.02] [--n-azimuth 900] [--keyframe-every 10] [--drift-rate 0.02]
        [--exclude-unreliable] [--tag T] [--out FILE] [--device cuda]

The protocol of the reference package's ``tools/loop_drive.py``: a ring
world (boxes and poles lining both sides of a circular course, pruned per
frame to 110 m of the sensor so the raycast stays tractable) driven for
``--laps`` laps by the lidar-only ``VloamDriver`` with loop closure, scan
noise high enough to drift visibly.  It records the drift at the revisit,
revisit detection on the drifted keyframe chain under the fixed gate
(radius 6 m) and the drift-scaled one (6 m + drift rate x path), and the
raw against the refined (pose graph with loop factors, ``close()``) error,
under the reference record's keys (``loop_drive<tag>``), plus where the time
went: ``frame_gen_s`` (the NumPy raycast on the host), ``process_s`` (the
driver's frames) and ``close_s``.

Prints one JSON line.  With ``--out`` the record is also merged into that
JSON file (never a ``VALIDATION_r0*.json``: those are the reference
package's records).  Full width only on the CLI; ``drive`` takes any config.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

PROGRESS_EVERY = 100     # frames between progress lines


def ring_world(radius: float, seed: int = 12) -> np.ndarray:
    """Boxes + poles lining BOTH sides of a circular course of ``radius``
    centred at (0, radius): structure every ~9 m of arc, varied shapes so
    scan registration always has edges and planes in range."""
    rng = np.random.default_rng(seed)
    cx, cy = 0.0, radius
    boxes = []
    n_around = int(2 * np.pi * radius / 9.0)
    for i in range(n_around):
        a = i * 2 * np.pi / n_around
        for r_off in (14.0, -14.0):
            r = radius + r_off + rng.uniform(-2.5, 2.5)
            x, y = cx + r * np.cos(a), cy + r * np.sin(a)
            if rng.uniform() < 0.35:
                # pole (edge feature)
                boxes.append([x, y, -1.7, x + 0.3, y + 0.3, rng.uniform(2.5, 4.5)])
            else:
                w, d = rng.uniform(3, 8), rng.uniform(3, 8)
                boxes.append([x, y, -1.7, x + w, y + d, -1.7 + rng.uniform(4, 14)])
    return np.array(boxes, np.float64)


def drive(cfg, frames: int = 1500, laps: int = 1, speed: float = 1.3, noise: float = 0.02,
          n_azimuth: int = 900, keyframe_every: int = 10, drift_rate: float = 0.02,
          device="cuda", verbose: bool = True) -> dict:
    """Run the ring course through ``VloamDriver(loop_closure=True)`` and
    ``close()``; returns the record."""
    from vloam_tpu_torch.data import synthetic
    from vloam_tpu_torch.models import frame_graph as fg
    from vloam_tpu_torch.parallel.loop_closure import detect_revisits
    from vloam_tpu_torch.runtime.driver import VloamDriver, resolve_device

    n = frames
    yaw_rate = laps * 2 * np.pi / n      # exactly ``laps`` laps
    radius = speed / yaw_rate
    if verbose:
        print(f"[loop_drive] {n} frames, {laps} lap(s), course length {n * speed:.0f} m, "
              f"radius {radius:.0f} m", flush=True)
    world = ring_world(radius)
    centers = (world[:, :3] + world[:, 3:]) / 2.0
    poses = synthetic.straight_trajectory(n, speed=speed, yaw_rate=yaw_rate)

    dev = resolve_device(device)
    driver = VloamDriver(cfg, fg.kitti_default_extrinsics(dev), loop_closure=True,
                         keyframe_every=keyframe_every, loop_radius=6.0, loop_min_travel=100.0,
                         loop_drift_rate=drift_rate, device=dev)
    t0 = time.perf_counter()
    gen_s = process_s = 0.0
    mo = []
    for i, (R, t) in enumerate(poses):
        tg = time.perf_counter()
        near = np.linalg.norm(centers[:, :2] - t[:2], axis=1) < 110.0
        cloud = synthetic.simulate_scan(R, t, world[near], n_azimuth=n_azimuth, noise=noise,
                                        seed=i)
        tp = time.perf_counter()
        driver.process(None, cloud)
        process_s += time.perf_counter() - tp
        gen_s += tp - tg
        mo.append(driver._w_mo64.copy())   # the f64 host chain (what the back end gates on)
        if verbose and i % PROGRESS_EVERY == 0:
            err = np.linalg.norm(mo[-1][4:] - t)
            print(f"  frame {i:4d}  MO err {err:7.2f} m  ({time.perf_counter() - t0:.0f} s)",
                  flush=True)
    mo = np.stack(mo)
    gt = np.stack([t for _, t in poses])

    # detection on the drifted keyframe chain: the fixed gate against the scaled one
    kf_ids = sorted(driver._keyframes)
    kf_pos = np.stack([mo[i][4:] for i in kf_ids if i < len(mo)])
    fixed_pairs = detect_revisits(kf_pos, min_gap=3, radius=6.0, min_spacing=2,
                                  min_travel=100.0)
    scaled_pairs = detect_revisits(kf_pos, min_gap=3, radius=6.0, min_spacing=2,
                                   min_travel=100.0, drift_rate=drift_rate)
    # drift at the true revisit point (end of the course against its start)
    loop_gap_est = float(np.linalg.norm(mo[-1, 4:] - mo[0, 4:]))
    raw_ate = float(np.mean(np.linalg.norm(mo[:, 4:] - gt, axis=1)))
    raw_final = float(np.linalg.norm(mo[-1, 4:] - gt[-1]))

    t_close = time.perf_counter()
    driver.close()        # detection + registration + pose graph
    close_s = time.perf_counter() - t_close

    def ate(chain):
        return None if chain is None else float(np.mean(np.linalg.norm(chain[:, 4:] - gt,
                                                                         axis=1)))

    refined, unguarded = driver._refined, driver._refined_unguarded
    ref_ate = ate(refined)
    ref_final = None if refined is None else float(np.linalg.norm(refined[-1, 4:] - gt[-1]))
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    return {
        "frames": n,
        "laps": laps,
        "refine_report": driver.refine_report,
        "f32_divergence_m": driver.f32_divergence_m,
        "path_len_m": round(path, 1),
        "keyframes": len(kf_pos),
        "scan_noise_m": noise,
        "drift_at_revisit_m": round(loop_gap_est, 2),
        "drift_pct_of_path": round(100.0 * loop_gap_est / path, 3),
        "detections_fixed_gate": len(fixed_pairs),
        "detections_drift_scaled_gate": len(scaled_pairs),
        "raw_ate_m": round(raw_ate, 3),
        "raw_final_err_m": round(raw_final, 3),
        "refined_ate_m": None if ref_ate is None else round(ref_ate, 3),
        "refined_final_err_m": None if ref_final is None else round(ref_final, 3),
        "unguarded_refined_ate_m": None if unguarded is None else round(ate(unguarded), 3),
        "drive_s": round(t_close - t0, 1),
        "close_s": round(close_s, 1),
        "frame_gen_s": round(gen_s, 1),
        "process_s": round(process_s, 1),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "note": (
            "multi-km loop with accumulated drift; detection gate comparison fixed (radius=6) "
            f"vs drift-scaled (radius=6 + {drift_rate}*path); pose graph with loop factors "
            "closes the lap; drive_s = frame_gen_s (host raycast) + process_s + bookkeeping"
        ),
    }


def main(argv=None) -> None:
    from vloam_tpu_torch.tools.validate_drive import check_out, merge_record

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=1500)
    ap.add_argument("--laps", type=int, default=1,
                    help="laps around the ring; >=2 spreads the revisits over the whole "
                         "course (every lap-2 keyframe has a lap-1 counterpart)")
    ap.add_argument("--speed", type=float, default=1.3)
    ap.add_argument("--noise", type=float, default=0.02)
    ap.add_argument("--n-azimuth", type=int, default=900)
    ap.add_argument("--keyframe-every", type=int, default=10)
    ap.add_argument("--drift-rate", type=float, default=0.02,
                    help="the driver's loop_drift_rate (gate growth per metre)")
    ap.add_argument("--exclude-unreliable", action="store_true",
                    help="original-LOAM unreliable-point exclusion")
    ap.add_argument("--tag", default="", help="suffix for the record key (loop_drive<tag>)")
    ap.add_argument("--out", default=None, help="merge the record into this JSON file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    check_out(ap, args.out)

    from vloam_tpu_torch.config import kitti_hdl64

    cfg = kitti_hdl64()
    if args.exclude_unreliable:
        cfg = cfg.replace(scan=dataclasses.replace(cfg.scan, exclude_unreliable=True))
    result = drive(cfg, args.frames, args.laps, args.speed, args.noise, args.n_azimuth,
                   args.keyframe_every, args.drift_rate, device=args.device)
    if args.out:
        merge_record(args.out, {"loop_drive" + args.tag: result})
    print(json.dumps(result))


if __name__ == "__main__":
    main()
