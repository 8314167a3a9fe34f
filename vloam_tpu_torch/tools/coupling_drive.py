"""Coupling at production scale: does the VO seed pay on a turn-rich course?

    python -m vloam_tpu_torch.tools.coupling_drive [--frames 400] [--speed 1.1]
        [--straight 60] [--turn-frames 12] [--noise 0.01] [--n-azimuth 900]
        [--sparse-every 3] [--sparse-keep 0.25] [--tag T] [--out FILE] [--device cuda]

The protocol of the reference package's ``tools/coupling_drive.py``: an
urban block course (``synthetic.turns_trajectory``: straights joined by
sharp 90-degree turns over ``--turn-frames`` frames, the real-KITTI turn
regime) through a world built along the route (``data/scenarios.
route_world``: boxes and poles on both sides, every ``--sparse-every``-th
straight thinned), with camera blob texture raycast onto the structure,
driven through ``VloamDriver`` in decoupled (D) and coupled (C) mode over
identical frames.  Per frame it records the seed telemetry: the rotation
and translation error of the VO seed, of the constant-motion warm start
and of the solved LO delta against the true motion, split by turn and
straight frames, so whichever mode wins, the telemetry says why.

The records are the reference's (``coupling_production_{mode}<_tag>`` and
``coupling_seed_telemetry<_tag>``), each mode's with ``frame_gen_s`` (the
scans and images, NumPy on the host) and ``process_s`` (the driver) added.
Prints one line a mode and the telemetry as JSON; with ``--out`` the
records are merged into that JSON file (never a ``VALIDATION_r0*.json``).
Full width only on the CLI; ``drive`` takes any config.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from vloam_tpu_torch import geometry as geo
from vloam_tpu_torch import geometry_np as gnp

PROGRESS_EVERY = 50     # frames between progress lines
BLOBS_SEED = 11


def route_world(poses, seed: int = 21, sparse_every: int = 3,
                sparse_keep: float = 0.25) -> np.ndarray:
    from vloam_tpu_torch.data.scenarios import route_world as rw

    return rw(poses, seed=seed, sparse_every=sparse_every, sparse_keep=sparse_keep)


def gt_delta(R0, t0, R1, t1) -> np.ndarray:
    """velo_last_T_velo_curr ground truth as (7,) [q|t]."""
    Rrel = R0.T @ R1
    trel = R0.T @ (t1 - t0)
    q = geo.matrix_to_quat(torch.tensor(Rrel, dtype=torch.float32)).numpy().astype(np.float64)
    return np.concatenate([q, trel])


def pose_err(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """(rotation deg, translation m) between two (7,) poses."""
    d = gnp.pose_compose(gnp.pose_inverse(gnp.as_pose64(a)), gnp.as_pose64(b))
    ang = 2.0 * np.arccos(np.clip(abs(d[3]), -1.0, 1.0))
    return float(np.degrees(ang)), float(np.linalg.norm(d[4:]))


def run_mode(cfg, poses, world, blobs_seed, n_azimuth, noise, couple, device="cuda"):
    """One mode over the course: (MO f64 chain (N, 7), per-frame telemetry,
    {"frame_gen_s", "process_s"})."""
    from vloam_tpu_torch.data import synthetic
    from vloam_tpu_torch.data.stream import camera_matrices
    from vloam_tpu_torch.models import frame_graph as fg
    from vloam_tpu_torch.runtime.driver import VloamDriver, resolve_device

    cfg = cfg.replace(detach_vo_lo=not couple)
    dev = resolve_device(device)
    ext = fg.kitti_default_extrinsics(dev)
    driver = VloamDriver(cfg, ext, device=dev)
    K = camera_matrices(ext)[0]
    centers = (world[:, :3] + world[:, 3:]) / 2.0

    rng = np.random.default_rng(blobs_seed)
    blob_world = np.zeros((0, 3))
    vc = cfg.visual
    tele, mo = [], []
    prev_lo = None
    secs = {"frame_gen_s": 0.0, "process_s": 0.0}
    t0 = time.perf_counter()
    for i, (R, t) in enumerate(poses):
        tg = time.perf_counter()
        R_wc = R @ synthetic.CAM_R_WORLD.T
        if i % 8 == 0:
            uv = np.stack([rng.uniform(20, vc.img_width - 20, 700),
                           rng.uniform(20, vc.img_height - 20, 700)], -1)
            pc, hit = synthetic.raycast_camera(R_wc, t, world, K, uv)
            blob_world = np.concatenate([blob_world, (pc[hit] @ R_wc.T) + t])
        near = np.linalg.norm(centers[:, :2] - t[:2], axis=1) < 110.0
        cloud = synthetic.simulate_scan(R, t, world[near], n_azimuth=n_azimuth, noise=noise,
                                        seed=i)
        vis = blob_world[np.linalg.norm(blob_world - t, axis=1) < 90.0]
        img = synthetic.render_blob_image((vis - t) @ R_wc, K, vc.img_height, vc.img_width)
        tp = time.perf_counter()
        driver.process(img, cloud)
        secs["process_s"] += time.perf_counter() - tp
        secs["frame_gen_s"] += tp - tg
        out = driver.host_out
        mo.append(driver._w_mo64.copy())
        if i > 0:
            gtd = gt_delta(*poses[i - 1], *poses[i])
            tele.append({
                "frame": i,
                "vo_seed": pose_err(gtd, out.vo_delta),
                "warm": pose_err(gtd, prev_lo) if prev_lo is not None else None,
                "lo_final": pose_err(gtd, out.lo_delta),
                "gt_yaw_deg": pose_err(np.array([0, 0, 0, 1, 0, 0, 0.0]), gtd)[0],
            })
        prev_lo = np.asarray(out.lo_delta)
        if i % PROGRESS_EVERY == 0:
            print(f"  [{'C' if couple else 'D'}] frame {i} ({time.perf_counter() - t0:.0f} s)",
                  flush=True)
    return np.stack(mo), tele, secs


def _median_errs(rows, key):
    vals = [r[key] for r in rows if r[key] is not None]
    if not vals:
        return None
    return [round(float(np.median([v[0] for v in vals])), 4),
            round(float(np.median([v[1] for v in vals])), 4)]


def drive(cfg, frames: int = 400, speed: float = 1.1, straight: int = 60,
          turn_frames: int = 12, noise: float = 0.01, n_azimuth: int = 900,
          sparse_every: int = 3, sparse_keep: float = 0.25, tag: str = "",
          device="cuda") -> dict:
    """Both modes over one course; returns the records keyed as the
    reference tool writes them."""
    from vloam_tpu_torch.data import synthetic
    from vloam_tpu_torch.tools.validate_drive import kitti_matrices
    from vloam_tpu_torch.utils import kitti_eval

    poses = synthetic.turns_trajectory(frames, speed=speed, straight=straight,
                                       turn_frames=turn_frames)
    world = route_world(poses, sparse_every=sparse_every, sparse_keep=sparse_keep)
    gt = np.stack([t for _, t in poses])
    gt34 = np.stack([np.concatenate([R, t[:, None]], 1) for R, t in poses])
    period = straight + turn_frames
    results, tele_summary = {}, {}
    for couple in (False, True):
        mode = "coupled_C" if couple else "decoupled_D"
        mo, tele, secs = run_mode(cfg, poses, world, BLOBS_SEED, n_azimuth, noise, couple,
                                  device)
        ev = kitti_eval.evaluate(gt34, kitti_matrices(mo))
        turn = [r for r in tele if r["frame"] % period >= straight]
        flat = [r for r in tele if r["frame"] % period < straight]
        keys = ("vo_seed", "warm", "lo_final")
        tele_summary[mode] = {
            "turn_frames": {k: _median_errs(turn, k) for k in keys},
            "straight_frames": {k: _median_errs(flat, k) for k in keys},
            "median_turn_yaw_deg_per_frame": round(
                float(np.median([r["gt_yaw_deg"] for r in turn])), 2) if turn else None,
        }
        results[mode] = {
            "mode": mode,
            "frames": frames,
            "path_len_m": round(float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1))), 1),
            "mo_trans_pct": round(ev["trans_pct"], 4),
            "mo_rot_deg_per_m": round(ev["rot_deg_per_m"], 5),
            "segments": ev["segments"],
            "ate_m": round(float(np.mean(np.linalg.norm(mo[:, 4:] - gt, axis=1))), 4),
            "final_err_m": round(float(np.linalg.norm(mo[-1, 4:] - gt[-1])), 4),
            **{k: round(v, 1) for k, v in secs.items()},
        }
        print(mode, json.dumps(results[mode]), flush=True)
    note = ("urban-turn course (90-degree turns over "
            f"{turn_frames} frames = ~{90.0 / turn_frames:.1f} deg/frame, the real-KITTI turn "
            "regime) with thinned-structure straights; seed telemetry medians are (rot deg, "
            "trans m) error vs ground-truth per-frame motion")
    suffix = f"_{tag}" if tag else ""
    record = {f"coupling_production_{mode}{suffix}": r for mode, r in results.items()}
    record[f"coupling_seed_telemetry{suffix}"] = {"note": note, **tele_summary}
    return record


def main(argv=None) -> None:
    from vloam_tpu_torch.tools.validate_drive import check_out, merge_record

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--speed", type=float, default=1.1)
    ap.add_argument("--straight", type=int, default=60)
    ap.add_argument("--turn-frames", type=int, default=12)
    ap.add_argument("--noise", type=float, default=0.01)
    ap.add_argument("--n-azimuth", type=int, default=900)
    ap.add_argument("--sparse-every", type=int, default=3)
    ap.add_argument("--sparse-keep", type=float, default=0.25)
    ap.add_argument("--tag", default="", help="suffix for the record keys")
    ap.add_argument("--out", default=None, help="merge the records into this JSON file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    check_out(ap, args.out)

    from vloam_tpu_torch.config import kitti_hdl64

    record = drive(kitti_hdl64(), args.frames, args.speed, args.straight, args.turn_frames,
                   args.noise, args.n_azimuth, args.sparse_every, args.sparse_keep, args.tag,
                   args.device)
    if args.out:
        merge_record(args.out, record)
    suffix = f"_{args.tag}" if args.tag else ""
    tele = dict(record[f"coupling_seed_telemetry{suffix}"])
    tele.pop("note")
    print(json.dumps(tele))


if __name__ == "__main__":
    main()
