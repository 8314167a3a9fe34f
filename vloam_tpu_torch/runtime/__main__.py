"""CLI entry point: ``python -m vloam_tpu_torch.runtime`` (port of
``vloam_tpu/runtime/__main__.py``: the same flags, plus ``--device``).

Replaces the reference's actionlib goal {date, seq, start_frame, end_frame}
(vloam_main.action:1-10) + launch-file parameter surface with flags.

It runs on the GPU unless ``--device cpu`` is given; without a GPU the
default raises.  ``--descriptor-match`` runs VO on ORB (or ``--descriptor
brief``) descriptors with the brute-force matcher.  Flags of features that
are not ported yet (``--refine``, ``--loop-closure``, ``--debug-dir``, the
other descriptor families and detectors, ``--matcher flann``, ``--clahe``,
``--distortion``, ``--exclude-unreliable``) are passed on and the module
that would implement them raises ``NotImplementedError``.

Examples:
  # synthetic end-to-end smoke (no data needed)
  python -m vloam_tpu_torch.runtime --dataset synthetic --frames 10

  # the same with VO matching ORB descriptors instead of tracking (KLT)
  python -m vloam_tpu_torch.runtime --dataset synthetic --frames 10 --descriptor-match

  # KITTI raw drive, decoupled mode, trajectories into results/
  python -m vloam_tpu_torch.runtime --dataset raw --root /data/kitti \\
      --date 2011_09_26 --seq 0001 --out results/2011_09_26_drive_0001

  # KITTI odometry benchmark sequence, coupled mode
  python -m vloam_tpu_torch.runtime --dataset odometry --root /data/kitti_odom \\
      --seq 00 --couple
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m vloam_tpu_torch.runtime",
                                description="vloam_tpu_torch sequence driver")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; a missing GPU raises)")
    p.add_argument("--dataset", choices=["synthetic", "raw", "odometry"], default="synthetic")
    p.add_argument("--root", help="dataset root directory")
    p.add_argument("--date", help="KITTI raw date, e.g. 2011_09_26")
    p.add_argument("--seq", help="drive number (raw, e.g. 0001) or sequence (odometry, e.g. 00)")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=None)
    p.add_argument("--frames", type=int, default=10, help="synthetic: number of frames")
    p.add_argument("--speed", type=float, default=0.8, help="synthetic: m/frame")
    p.add_argument("--out", default=None, help="trajectory output directory")
    p.add_argument("--couple", action="store_true", help="coupled VO+LO mode (detach_VO_LO=false)")
    p.add_argument("--lidar-only", action="store_true", help="skip VO (A-LOAM mode)")
    p.add_argument("--refine", action="store_true",
                   help="post-sequence pose-graph fusion of the VO/LO/MO chains "
                        "(writes MO{d}_refined.txt)")
    p.add_argument("--loop-closure", action="store_true",
                   help="detect revisits, register loop factors, and include "
                        "them in the --refine pose graph (implies --refine)")
    p.add_argument("--keyframe-every", type=int, default=10,
                   help="loop-closure keyframe period in frames")
    p.add_argument("--loop-radius", type=float, default=6.0,
                   help="revisit proximity gate (m) at zero traveled path")
    p.add_argument("--loop-min-travel", type=float, default=20.0,
                   help="minimum traveled path (m) between loop keyframes — "
                        "gates on path length, not index gap, so stopped "
                        "segments cannot register spurious revisits")
    p.add_argument("--loop-drift-rate", type=float, default=0.05,
                   help="revisit gate growth per metre traveled between the "
                        "keyframes.  Must be at least the course's observed "
                        "odometry drift rate or detection silently misses "
                        "(the 1949 m demo lap drifts 4.1%% and needs 0.05; "
                        "0.02 detected nothing there, VALIDATION_r04)")
    p.add_argument("--loop-min-gap", type=int, default=3,
                   help="minimum keyframe index gap for a revisit candidate")
    p.add_argument("--beams", type=int, default=64, choices=[16, 32, 64])
    p.add_argument("--json", action="store_true", help="print metrics as one JSON line")
    p.add_argument("--checkpoint-dir", default=None, help="save pipeline state snapshots here")
    p.add_argument("--checkpoint-every", type=int, default=0, help="snapshot period in frames")
    p.add_argument("--resume", default=None, help="checkpoint path to resume from")
    # launch-file parameter surface (vloam_main.launch:4-16,
    # loam_velodyne_HDL_64_kitti.launch:3-16)
    p.add_argument("--clahe", action="store_true", help="CLAHE pre-equalisation")
    p.add_argument("--keypoint-nms", action="store_true", help="bucketed keypoint NMS")
    p.add_argument("--descriptor-match", action="store_true",
                   help="ORB descriptor matching instead of KLT (optical_flow_match=false)")
    p.add_argument("--detector", default="shitomasi",
                   choices=["shitomasi", "fast", "brisk", "orb", "akaze", "sift"])
    p.add_argument("--descriptor", default=None,
                   choices=["orb", "brief", "brisk", "freak", "akaze", "sift"],
                   help="descriptor family (descriptor-match mode)")
    p.add_argument("--matcher", default=None, choices=["bf", "flann"])
    p.add_argument("--match-select", default=None, choices=["knn", "nn"])
    p.add_argument("--remove-vo-outlier", type=float, default=None,
                   help="pixel displacement gate (reference remove_VO_outlier)")
    p.add_argument("--reset-vo-to-identity", action="store_true")
    p.add_argument("--line-res", type=float, default=None, help="mapping_line_resolution")
    p.add_argument("--plane-res", type=float, default=None, help="mapping_plane_resolution")
    p.add_argument("--mapping-skip-frame", type=int, default=None)
    p.add_argument("--exclude-unreliable", action="store_true",
                   help="original-LOAM occluded/parallel-beam point exclusion "
                        "(dropped by the A-LOAM-derived reference; removes "
                        "sensor-relative false edges)")
    p.add_argument("--distortion", action="store_true",
                   help="per-point slerp motion compensation in LO "
                        "(TransformToStart/End; off for pre-synced KITTI)")
    p.add_argument("--verbose-level", type=int, default=1, help="loam_verbose_level")
    p.add_argument("--debug-dir", default=None,
                   help="dump keypoint/flow/depth debug PNGs here (replaces the "
                        "visualize_depth / visualize_optical_flow rviz topics)")
    p.add_argument("--debug-every", type=int, default=10)
    args = p.parse_args(argv)

    import dataclasses

    from vloam_tpu_torch.config import hdl32, kitti_hdl64, vlp16

    cfg = {64: kitti_hdl64, 32: hdl32, 16: vlp16}[args.beams]()
    if args.couple:
        cfg = cfg.replace(detach_vo_lo=False)
    vis_kw = {
        "clahe": args.clahe,
        "keypoint_nms": args.keypoint_nms,
        "detector_type": args.detector,
        "reset_vo_to_identity": args.reset_vo_to_identity,
    }
    if args.descriptor_match:
        vis_kw["optical_flow_match"] = False
    if args.descriptor is not None:
        vis_kw["descriptor_type"] = args.descriptor
    if args.matcher is not None:
        vis_kw["matcher_type"] = args.matcher
    if args.match_select is not None:
        vis_kw["match_select"] = args.match_select
    if args.remove_vo_outlier is not None:
        vis_kw["remove_vo_outlier"] = args.remove_vo_outlier
    cfg = cfg.replace(visual=dataclasses.replace(cfg.visual, **vis_kw),
                      verbose_level=args.verbose_level)
    map_kw = {}
    if args.line_res is not None:
        map_kw["line_resolution"] = args.line_res
    if args.plane_res is not None:
        map_kw["plane_resolution"] = args.plane_res
    if args.mapping_skip_frame is not None:
        map_kw["skip_frame"] = args.mapping_skip_frame
    if args.distortion:
        cfg = cfg.replace(odom=dataclasses.replace(cfg.odom, distortion=True))
    if args.exclude_unreliable:
        cfg = cfg.replace(scan=dataclasses.replace(cfg.scan, exclude_unreliable=True))
    if map_kw:
        cfg = cfg.replace(mapping=dataclasses.replace(cfg.mapping, **map_kw))

    from vloam_tpu_torch.runtime.driver import run_kitti, run_synthetic

    # --keyframe-every and the four --loop-* gates only tune loop closure, and
    # --debug-every the debug dumps; VloamDriver refuses both features
    # (ROADMAP A10, A9), so these are not passed on
    if args.dataset == "synthetic":
        res = run_synthetic(
            cfg, n_frames=args.frames, speed=args.speed, out_dir=args.out,
            verbose=not args.json, lidar_only=args.lidar_only, refine=args.refine,
            loop_closure=args.loop_closure, device=args.device,
        )
    else:
        from vloam_tpu_torch.data.kitti import OdometrySequence, RawSequence

        if args.dataset == "raw":
            seq = RawSequence(args.root, args.date, args.seq, with_images=not args.lidar_only)
        else:
            seq = OdometrySequence(args.root, args.seq, with_images=not args.lidar_only)
        res = run_kitti(cfg, seq, out_dir=args.out, start=args.start, end=args.end,
                        verbose=not args.json, checkpoint_dir=args.checkpoint_dir,
                        checkpoint_every=args.checkpoint_every, resume=args.resume,
                        debug_dir=args.debug_dir,
                        refine=args.refine, loop_closure=args.loop_closure,
                        device=args.device)
    if args.json:
        print(json.dumps(res))


if __name__ == "__main__":
    main()
