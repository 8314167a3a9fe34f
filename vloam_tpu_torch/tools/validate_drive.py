"""The long validation drive: accuracy and steady frame time of the full step.

    python -m vloam_tpu_torch.tools.validate_drive [--frames 300] [--couple] [--hard]
        [--exclude-unreliable] [--out FILE] [--device cuda]

Drives ``vloam_step`` (pre-built host inputs, the step ``bench.py`` times)
over a snake course through the synthetic street (default 300 frames at
0.9 m a frame, yaw amplitude 0.004: ~270 m with several cube-grid
crossings) with exact ground truth, and scores the MO chain by the KITTI
protocol of ``utils/kitti_eval`` (translational error % and rotational
deg/m over 100-800 m segments, null when the drive has none) and by its ATE
and final error.  The steady time runs from frame 4 to the end and is closed
by one fetch of the last frame's pose.  The protocol, record keys and mode
names (``decoupled_D`` / ``coupled_C``, prefixed ``hard_`` and ``excl_``)
are those of the reference package's ``tools/validate_drive.py``.
``--hard`` drives the stressor world of ``data/stream`` (vehicles, a
textureless stretch, an open plaza); ``--exclude-unreliable`` turns on
``ScanConfig.exclude_unreliable``.

Prints one JSON line.  With ``--out`` the record is also merged, keyed by
mode, into that JSON file.  The synthetic world is easier than KITTI: the
numbers check the engine, they are not a KITTI result.
"""

from __future__ import annotations

import argparse
import dataclasses
import fnmatch
import json
import os
import time

import numpy as np
import torch

from vloam_tpu_torch import geometry as geo
from vloam_tpu_torch.utils import kitti_eval

STEADY_FROM = 4     # frames before the timed window (the first uses and the warm-up)


def kitti_matrices(poses) -> np.ndarray:
    """(N, 7) poses -> (N, 3, 4) float32 matrices, built in float32 as the
    reference's tools build the matrices they score (the KITTI rotation
    error is an arccos near 1, where float32 and float64 matrices of the
    same pose differ by ~2e-4 deg/m)."""
    p = torch.as_tensor(np.asarray(poses, np.float32))
    return torch.cat([geo.quat_to_matrix(p[:, :4]), p[:, 4:, None]], dim=2).numpy()


def mode_name(cfg, hard: bool) -> str:
    mode = "decoupled_D" if cfg.detach_vo_lo else "coupled_C"
    if hard:
        mode = "hard_" + mode
    if cfg.scan.exclude_unreliable:
        mode = "excl_" + mode
    return mode


def drive(cfg, ext, frames, poses, hard: bool = False, frame_gen_s: float | None = None) -> dict:
    """Run the step over host frames (``data/stream.gen_frames``' tuples) on
    ``ext``'s device and score it against ``poses``.  Returns the record."""
    from vloam_tpu_torch.models.vloam import frame_to_device, init_vloam_state, vloam_step

    dev = ext.P_rect0.device
    dframes = [frame_to_device(*f, dev) for f in frames]
    state = init_vloam_state(cfg, dev)
    outs = []
    t_steady = None
    for k, (img, grid, gmask, buckets, lf) in enumerate(dframes):
        state, out = vloam_step(state, img, grid, gmask, ext, cfg, pre_gridded=True,
                                pre_buckets=buckets, pre_lf_table=lf)
        outs.append(out.world_mo)
        if k == STEADY_FROM - 1:
            out.world_mo.cpu()
            t_steady = time.perf_counter()
    outs[-1].cpu()        # the one fetch that closes the timed window
    t_end = time.perf_counter()
    n_timed = len(dframes) - STEADY_FROM
    mo = torch.stack(outs).cpu().numpy()

    est = kitti_matrices(mo)
    gt = np.stack([np.concatenate([R, t[:, None]], axis=1) for R, t in poses])
    res = kitti_eval.evaluate(gt, est)
    path_len = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)))
    final_err = float(np.linalg.norm(est[-1, :3, 3] - gt[-1, :3, 3]))
    steady_ms = (t_end - t_steady) / n_timed * 1e3 if n_timed > 0 else None
    segments = res["segments"]
    return {
        "mode": mode_name(cfg, hard),
        "frames": len(frames),
        "path_len_m": round(path_len, 1),
        "mo_trans_pct": round(res["trans_pct"], 4) if segments else None,
        "mo_rot_deg_per_m": round(res["rot_deg_per_m"], 5) if segments else None,
        "segments": segments,
        "ate_m": round(kitti_eval.ate(gt, est), 4),
        "final_err_m": round(final_err, 4),
        "final_err_pct": round(100.0 * final_err / path_len, 4),
        "steady_ms_per_frame": steady_ms,
        "fps": round(1e3 / steady_ms, 1) if steady_ms else None,
        "frame_gen_s": None if frame_gen_s is None else round(frame_gen_s, 1),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "note": (("stressor world: oncoming and crossing vehicles (lidar and camera), a "
                  "12-frame textureless stretch, an open plaza; " if hard
                  else "synthetic street with exact ground truth; ")
                 + "KITTI 100-800 m segment protocol on the MO chain; an engine check, "
                 "not a KITTI result"),
    }


def check_out(ap: argparse.ArgumentParser, out: str | None) -> None:
    """Refuse an ``--out`` that names one of the reference package's records."""
    if out and fnmatch.fnmatch(os.path.basename(out), "VALIDATION_r0*.json"):
        ap.error(f"{out} is a record of the reference package; choose another file")


def merge_record(path: str, entries: dict) -> None:
    """Merge ``entries`` (record key -> record) into the JSON file ``path``."""
    record = {}
    if os.path.exists(path):
        with open(path) as f:
            record = json.load(f)
    record.update(entries)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--speed", type=float, default=0.9)
    ap.add_argument("--yaw-rate", type=float, default=0.004, help="the snake's yaw amplitude")
    ap.add_argument("--couple", action="store_true", help="coupled mode (detach_VO_LO=false)")
    ap.add_argument("--hard", action="store_true", help="the stressor world")
    ap.add_argument("--exclude-unreliable", action="store_true",
                    help="original-LOAM occluded/parallel-beam exclusion")
    ap.add_argument("--out", default=None, help="merge the record into this JSON file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    check_out(ap, args.out)

    from vloam_tpu_torch.config import kitti_hdl64
    from vloam_tpu_torch.data import stream
    from vloam_tpu_torch.models import frame_graph as fg
    from vloam_tpu_torch.runtime.driver import resolve_device

    cfg = kitti_hdl64().replace(detach_vo_lo=not args.couple)
    if args.exclude_unreliable:
        cfg = cfg.replace(scan=dataclasses.replace(cfg.scan, exclude_unreliable=True))
    ext = fg.kitti_default_extrinsics(resolve_device(args.device))
    t0 = time.perf_counter()
    frames, poses = stream.gen_frames(cfg, ext, args.frames, speed=args.speed,
                                      yaw_rate=args.yaw_rate, snake=True, hard=args.hard)
    result = drive(cfg, ext, frames, poses, hard=args.hard,
                   frame_gen_s=time.perf_counter() - t0)
    if args.out:
        merge_record(args.out, {result["mode"]: result})
    print(json.dumps(result))


if __name__ == "__main__":
    main()
