"""The ImageUtil facade: the 2D feature frontend as one dispatch surface
(port of ``vloam_tpu/image_util.py``; the reference's
``image_util.h:16-101``).

  DetectorType    {ShiTomasi, BRISK, FAST, ORB, AKAZE, SIFT}
                  -> det_keypoints(detector_type=...)
  DescriptorType  {BRISK, ORB, BRIEF, AKAZE, FREAK, SIFT}
                  -> desc_keypoints(descriptor_type=...)
  MatcherType     {BF, FLANN} x SelectType {NN, KNN}
                  -> match(matcher_type=..., select=...)
  calculateOpticalFlow -> ops.image_ops.lk_track / lk_track_fb
  keyPointsNMS         -> ops.image_ops.bucket_nms

Keypoints are one fixed-shape tuple (pts, mask, response, octave, angle)
whatever the detector; single-scale detectors (ShiTomasi, FAST) report
octave 0.  The "ORB" detector is FAST re-scored by the Shi-Tomasi
cornerness, as cv::ORB's Harris score re-ranks.  Each family's module is
imported in its own branch, so a frontend imports only what it runs.
Binary descriptors are int32 words (``ops/orb``), SIFT's are float32: the
dtype picks the matcher's metric.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from vloam_tpu_torch.config import VisualConfig
from vloam_tpu_torch.ops import image_ops as _io

DETECTOR_TYPES = ("shitomasi", "brisk", "fast", "orb", "akaze", "sift")
DESCRIPTOR_TYPES = ("brisk", "orb", "brief", "akaze", "freak", "sift")
MATCHER_TYPES = ("bf", "flann")
SELECT_TYPES = ("nn", "knn")


class Keypoints(NamedTuple):
    pts: torch.Tensor        # (N, 2) full-res xy
    mask: torch.Tensor       # (N,)
    response: torch.Tensor   # (N,)
    octave: torch.Tensor     # (N,) int32 (0 for single-scale detectors)
    angle: torch.Tensor      # (N,) radians (0 until a descriptor orients them)


def single_scale(pts, mask, resp) -> Keypoints:
    """Keypoints of a single-scale detector: octave 0, angle 0."""
    n = pts.shape[0]
    return Keypoints(pts, mask, resp, torch.zeros((n,), dtype=torch.int32, device=pts.device),
                     torch.zeros((n,), dtype=torch.float32, device=pts.device))


def det_keypoints(img: torch.Tensor, detector_type: str, cfg: VisualConfig) -> Keypoints:
    """detKeypoints (image_util.cpp:8-192): corner or blob detection with a
    fixed ``cfg.max_corners`` budget."""
    t = detector_type.lower()
    if t in ("shitomasi", "fast"):
        return single_scale(*_io.detect_corners(img, dataclasses.replace(cfg, detector_type=t)))
    if t == "orb":
        # cv::ORB: FAST corners, Harris-score re-ranked.  detect_corners
        # already budgets by response; re-score survivors by Shi-Tomasi.
        pts, mask, _ = _io.detect_corners(img, dataclasses.replace(cfg, detector_type="fast"))
        st = _io.shi_tomasi_response(img, cfg.block_size)
        xi = torch.clamp(pts[:, 0].to(torch.int64), 0, img.shape[1] - 1)
        yi = torch.clamp(pts[:, 1].to(torch.int64), 0, img.shape[0] - 1)
        return single_scale(pts, mask, torch.where(mask, st[yi, xi], 0.0))
    if t == "brisk":
        from vloam_tpu_torch.ops import brisk

        kp = brisk.brisk_detect(img, cfg.max_corners, cfg.fast_threshold)
        return Keypoints(kp.pts, kp.mask, kp.response, kp.octave, torch.zeros_like(kp.response))
    if t == "akaze":
        from vloam_tpu_torch.ops import akaze

        return Keypoints(*akaze.detect(img, cfg.max_corners))
    if t == "sift":
        from vloam_tpu_torch.ops import sift

        kp = sift.detect(img, cfg.max_corners)
        return Keypoints(kp.pts, kp.mask, kp.response, kp.octave, kp.angle)
    raise ValueError(f"unknown detector_type {detector_type!r} ({DETECTOR_TYPES})")


def key_points_nms(kp: Keypoints, cfg: VisualConfig) -> Keypoints:
    """keyPointsNMS (image_util.cpp:202-261): bucketed per-cell cap."""
    return kp._replace(mask=_io.bucket_nms(kp.pts, kp.mask, kp.response, cfg))


def desc_keypoints(img: torch.Tensor, kp: Keypoints, descriptor_type: str, cfg: VisualConfig):
    """descKeypoints (image_util.cpp:280-339).  Returns (descriptors, valid):
    binary families (N, 8 | 16) int32 words, SIFT (N, 128) float32."""
    t = descriptor_type.lower()
    if t in ("orb", "brief"):
        from vloam_tpu_torch.ops import orb

        return orb.orb_descriptors(img, kp.pts, kp.mask, cfg, rotate=(t == "orb"))
    if t in ("brisk", "freak"):
        from vloam_tpu_torch.ops import brisk

        sk = brisk.ScaleKeypoints(kp.pts, kp.mask, kp.response, kp.octave)
        fn = brisk.brisk_descriptors if t == "brisk" else brisk.freak_descriptors
        return fn(img, sk)
    if t == "akaze":
        from vloam_tpu_torch.ops import akaze

        desc, valid, _ = akaze.describe(img, akaze.AkazeKeypoints(*kp))
        return desc, valid
    if t == "sift":
        from vloam_tpu_torch.ops import sift

        octs = sift.gaussian_octaves(img)
        sk = sift.SiftKeypoints(kp.pts, kp.mask, kp.response, kp.octave,
                                torch.ones_like(kp.octave), kp.angle)
        return sift.describe(octs, sift.orient(octs, sk))
    raise ValueError(f"unknown descriptor_type {descriptor_type!r} ({DESCRIPTOR_TYPES})")


def match(desc0, mask0, desc1, mask1, matcher_type: str = "bf", select: str = "knn",
          ratio: float = 0.8):
    """matchDescriptors (image_util.cpp:347-438): ``bf`` is the exact
    distance matrix, ``flann`` an approximate prefilter and an exact
    re-rank.  int32 words are matched by Hamming distance, float32 by L2."""
    if desc0.dtype == torch.int32:
        from vloam_tpu_torch.ops import orb

        if matcher_type == "bf":
            return orb.match_descriptors(desc0, mask0, desc1, mask1, ratio, select)
        if matcher_type == "flann":
            return orb.match_descriptors_approx(desc0, mask0, desc1, mask1, ratio)
    elif desc0.dtype == torch.float32:
        from vloam_tpu_torch.ops import sift

        if matcher_type == "bf":
            return sift.match_float_descriptors(desc0, mask0, desc1, mask1, ratio, select)
        if matcher_type == "flann":
            return sift.match_float_descriptors_approx(desc0, mask0, desc1, mask1, ratio)
    else:
        raise ValueError(f"match: descriptors must be int32 words or float32, not {desc0.dtype}")
    raise ValueError(f"unknown matcher_type {matcher_type!r} ({MATCHER_TYPES})")


def calculate_optical_flow(prev_img: torch.Tensor, img: torch.Tensor, kp: Keypoints,
                           cfg: VisualConfig):
    """calculateOpticalFlow (image_util.cpp:503-570): pyramidal LK; returns
    (tracked pts, status)."""
    track = _io.lk_track_fb if cfg.klt_fb_check else _io.lk_track
    return track(prev_img, img, kp.pts, kp.mask, cfg, None)
