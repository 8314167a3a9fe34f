"""The coupling switch, (C) against (D), on its two stress scenarios.

    python -m vloam_tpu_torch.tools.coupling_scenarios [--frames 80] [--verbose]
        [--out FILE] [--device cuda]

The protocol of the reference package's ``tools/coupling_scenarios.py``: two
scenarios of ``data/scenarios``, each driven through ``VloamDriver`` in both
modes (``compare_modes``):

* corridor: lidar-degenerate, so coupled must win (the VO seed supplies
  the wall-parallel translation LO cannot observe);
* highway: a lead vehicle and sparse structure, so coupled must lose (the
  truck-locked VO seed selects the wrong Huber basin) while decoupled's
  constant-velocity warm start stays robust (the reference's Table I,
  sequence 01: C 45.36 % against D 2.72 %).

Prints the reference tool's lines and one JSON line; with ``--out`` the
record is merged under ``coupling_scenarios`` into that JSON file (never a
``VALIDATION_r0*.json``).  Full width only on the CLI; ``scenarios`` takes
any config.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

NOTE = ("synthetic stress scenarios for the (C)/(D) switch: corridor = lidar-degenerate "
        "(coupled must win), highway = lead vehicle + sparse structure (coupled must degrade, "
        "the seq-01 signature; reference Table-I seq 01: C 45.36 % vs D 2.72 %)")


def _print_modes(res: dict, t0: float) -> None:
    for m, r in res.items():
        print(f"  {m}: final {r['final_err_pct']:.1f} % progress {r['x_progress_ratio']:.2f}")
    print(f"  both modes {time.perf_counter() - t0:.1f} s (scans, images and the driver)",
          flush=True)


def corridor(cfg, frames: int = 80, verbose: bool = False, device="cuda") -> dict:
    """The corridor in both modes: {mode: record}."""
    from vloam_tpu_torch.data import scenarios as sc
    from vloam_tpu_torch.data import synthetic

    n, speed = frames, 0.9
    length = n * speed + 40.0
    walls = sc.corridor_scene(length)
    tex = sc.corridor_texture(length)
    poses = synthetic.straight_trajectory(n, speed=speed)
    print(f"[corridor] {n} frames, {n * speed:.0f} m, degenerate LO geometry", flush=True)
    t0 = time.perf_counter()
    res = sc.compare_modes(cfg, poses, lambda i: walls, lambda i: tex, verbose=verbose,
                           device=device)
    _print_modes(res, t0)
    return res


def highway(cfg, frames: int = 80, verbose: bool = False, device="cuda") -> dict:
    """The highway behind a lead truck in both modes: {mode: record}."""
    from vloam_tpu_torch.data import scenarios as sc

    speeds = sc.highway_speeds(frames)
    poses = sc.straight_poses_from_speeds(speeds)
    length = float(np.sum(speeds)) + 60.0
    static = sc.highway_static_scene(length)
    static_tex = sc.highway_static_texture(length)

    def boxes_fn(i):
        return np.concatenate([static, sc.truck_box(poses[i][1][0] + 14.0)])

    def texture_fn(i):
        return np.concatenate([sc.truck_texture(poses[i][1][0] + 14.0), static_tex])

    print(f"[highway] {frames} frames, {np.sum(speeds):.0f} m, lead truck @14 m gap", flush=True)
    t0 = time.perf_counter()
    res = sc.compare_modes(cfg, poses, boxes_fn, texture_fn, verbose=verbose, device=device)
    _print_modes(res, t0)
    return res


def scenarios(cfg, frames: int = 80, verbose: bool = False, device="cuda") -> dict:
    """Both scenarios in both modes: {"corridor": {mode: record}, "highway": {...}}."""
    return {"corridor": corridor(cfg, frames, verbose, device),
            "highway": highway(cfg, frames, verbose, device)}


def main(argv=None) -> None:
    from vloam_tpu_torch.tools.validate_drive import check_out, merge_record

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--out", default=None, help="merge the record into this JSON file")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    check_out(ap, args.out)

    from vloam_tpu_torch.config import kitti_hdl64

    results = scenarios(kitti_hdl64(), args.frames, args.verbose, device=args.device)
    if args.out:
        merge_record(args.out, {"coupling_scenarios": {"note": NOTE, **results}})
    print(json.dumps(results))


if __name__ == "__main__":
    main()
