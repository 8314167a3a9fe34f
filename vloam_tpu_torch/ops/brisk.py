"""BRISK and FREAK: pattern-sampling binary features (port of
``vloam_tpu/ops/brisk.py``; the reference's ``DetectorType::BRISK``,
``DescriptorType::BRISK`` and ``DescriptorType::FREAK``).

  * detector: the FAST-9/16 response (``image_ops.fast_response``) on a
    4-octave pyramid, a 3x3 non-max of wrapping rolls, a border margin, and
    per octave the ``max_keypoints // 4`` strongest (the reference's
    ``approx_max_k`` takes its exact CPU branch here: ``image_ops.top_k``);
  * descriptors: BRISK's concentric pattern (60 points) and FREAK's retinal
    pattern (43 points) are sampled the same way.  At each octave every
    keypoint's 32x32 window is cut from the octave's 3-level blur stack in
    one launch of the stacked patch gather (``patch_gather.
    gather_patches_stack``, the CUDA kernel B2), and every pattern point is
    the bilinear blend of four of those pixels, from a bank of 30
    pre-rotated copies of the pattern (2pi/30 rotation bins);
  * orientation: BRISK's long-pair gradient, FREAK's symmetric-pair
    gradient; then the rotated pattern's pair comparisons, packed into 16
    words of 32 bits (int32 holding the reference's uint32 bit patterns,
    see ``ops/orb``).

The sampling computes the reference's product of the bf16-rounded patches
with its dense bf16-rounded tap bank (f32 accumulation, ``brisk.py:285-289``)
as a four-tap gather (``image_ops.sample_taps``).

The pattern and pair tables are NumPy, copied from the reference so that the
arrays come out equal (FREAK's pairs are drawn by ``default_rng(77)``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from vloam_tpu_torch.ops.image_ops import (_bf16, _sep_conv, border_mask, fast_response,
                                           neighbour_max, sample_taps, top_k)
from vloam_tpu_torch.ops.orb import pack_bits
from vloam_tpu_torch.ops.patch_gather import gather_patches_stack

N_OCTAVES = 4
PATCH = 32
BLUR_SIGMAS = (0.8, 1.8, 3.2)     # pattern-point smoothing levels
N_BITS = 512
N_ROT = 30                        # pre-rotated pattern grids (ORB's 2pi/30 binning)
_G5 = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]


class ScaleKeypoints(NamedTuple):
    pts: torch.Tensor        # (N, 2) full-res xy
    mask: torch.Tensor       # (N,)
    response: torch.Tensor   # (N,)
    octave: torch.Tensor     # (N,) int32


def brisk_detect(img: torch.Tensor, max_keypoints: int = 1024,
                 threshold: float = 20.0) -> ScaleKeypoints:
    """Multi-scale FAST keypoints: ``max_keypoints // 4`` slots an octave."""
    per_oct = max_keypoints // N_OCTAVES
    pts, msk, rsp, ocs = [], [], [], []
    level = img
    for o in range(N_OCTAVES):
        resp = fast_response(level, threshold)
        H, W = resp.shape
        keep = ((resp > 0) & (resp >= neighbour_max(resp))
                & border_mask(H, W, PATCH // 2 + 1, img.device))
        top, idx = top_k(torch.where(keep, resp, 0.0).reshape(-1), per_oct)
        x = (idx % W).to(torch.float32)
        y = (idx // W).to(torch.float32)
        sf = float(2 ** o)
        pts.append(torch.stack([(x + 0.5) * sf - 0.5, (y + 0.5) * sf - 0.5], dim=-1))
        msk.append(top > 0.0)
        rsp.append(top)
        ocs.append(torch.full((per_oct,), o, dtype=torch.int32, device=img.device))
        level = _sep_conv(level, _G5, _G5)[::2, ::2]
    return ScaleKeypoints(torch.cat(pts), torch.cat(msk), torch.cat(rsp), torch.cat(ocs))


# --------------------------------------------------------------------------
# The pattern and pair tables (NumPy, as the reference's)
# --------------------------------------------------------------------------

def _brisk_pattern() -> tuple[np.ndarray, np.ndarray]:
    """(60, 2) point offsets + (60,) blur-level ids (BRISK paper geometry:
    rings of [1, 10, 14, 15, 20] points at radii [0, 2.9, 4.9, 7.4, 10.8],
    smoothing growing with ring radius)."""
    counts = [1, 10, 14, 15, 20]
    radii = [0.0, 2.9, 4.9, 7.4, 10.8]
    blur = [0, 0, 1, 1, 2]
    xy, lv = [], []
    for ring, (n, r, b) in enumerate(zip(counts, radii, blur)):
        for k in range(n):
            a = 2 * math.pi * k / n + (math.pi / n if ring % 2 else 0.0)
            xy.append((r * math.cos(a), r * math.sin(a)))
            lv.append(b)
    return np.array(xy, np.float32), np.array(lv, np.int32)


def _freak_pattern() -> tuple[np.ndarray, np.ndarray]:
    """(43, 2) retinal pattern: 7 rings of 6 + centre, radii shrinking
    exponentially toward the fovea, smoothing proportional to radius."""
    xy, lv = [(0.0, 0.0)], [0]
    for ring in range(7):
        r = 13.0 * (0.72 ** ring)
        b = 2 if r > 8 else (1 if r > 3.5 else 0)
        for k in range(6):
            a = 2 * math.pi * k / 6 + (math.pi / 6 if ring % 2 else 0.0)
            xy.append((r * math.cos(a), r * math.sin(a)))
            lv.append(b)
    return np.array(xy, np.float32), np.array(lv, np.int32)


def _pairs_by_distance(xy: np.ndarray, short_max: float, long_min: float):
    """(all short pairs -> descriptor bits, all long pairs -> orientation)."""
    n = xy.shape[0]
    ii, jj = np.triu_indices(n, 1)
    d = np.linalg.norm(xy[ii] - xy[jj], axis=1)
    short = np.stack([ii, jj], 1)[d < short_max]
    long = np.stack([ii, jj], 1)[d > long_min]
    # fixed 512 bits: shortest-first, truncate or tile
    order = np.argsort(d[d < short_max])
    short = short[order]
    reps = -(-N_BITS // max(len(short), 1))
    short = np.tile(short, (reps, 1))[:N_BITS]
    return short.astype(np.int32), long.astype(np.int32)


_BRISK_XY, _BRISK_LV = _brisk_pattern()
_BRISK_SHORT, _BRISK_LONG = _pairs_by_distance(_BRISK_XY, 9.75, 13.67)
_FREAK_XY, _FREAK_LV = _freak_pattern()


def _freak_pairs() -> tuple[np.ndarray, np.ndarray]:
    """512 seeded coarse-to-fine pairs (stand-in for OpenCV's trained table)
    + 21 symmetric orientation pairs (opposite points of each ring)."""
    n = _FREAK_XY.shape[0]
    ii, jj = np.triu_indices(n, 1)
    pairs = np.stack([ii, jj], 1)
    r = np.linalg.norm(_FREAK_XY, axis=1)
    coarse = r[ii] + r[jj]                     # prefer coarse first (FREAK order)
    order = np.argsort(-coarse, kind="stable")
    rng = np.random.default_rng(77)
    keep = order[rng.permutation(len(order))[: N_BITS]]
    desc_pairs = pairs[np.sort(keep)]
    # orientation pairs: opposite points within each ring (k, k+3 of 6)
    opairs = []
    for ring in range(7):
        base = 1 + 6 * ring
        for k in range(3):
            opairs.append((base + k, base + k + 3))
    return desc_pairs.astype(np.int32), np.array(opairs, np.int32)


_FREAK_DESC_PAIRS, _FREAK_ORI_PAIRS = _freak_pairs()


def _pattern_tap_bank(pat_xy: np.ndarray, pat_lv: np.ndarray,
                      n_rot: int) -> tuple[np.ndarray, np.ndarray]:
    """Bilinear tap tables for n_rot pre-rotated copies of the pattern:
    (idx (n_rot*K, 4) int32 into the blur-level-major (3*P*P) patch stack,
    w (n_rot*K, 4) float32)."""
    idx_all, w_all = [], []
    for b in range(n_rot):
        th = b * 2.0 * np.pi / n_rot
        c, s = np.cos(th), np.sin(th)
        px = (c * pat_xy[:, 0] - s * pat_xy[:, 1]) + (PATCH - 1) / 2.0
        py = (s * pat_xy[:, 0] + c * pat_xy[:, 1]) + (PATCH - 1) / 2.0
        x0 = np.clip(np.floor(px), 0, PATCH - 2).astype(np.int64)
        y0 = np.clip(np.floor(py), 0, PATCH - 2).astype(np.int64)
        fx = np.clip(px - x0, 0.0, 1.0)
        fy = np.clip(py - y0, 0.0, 1.0)
        base = pat_lv.astype(np.int64) * (PATCH * PATCH) + y0 * PATCH + x0
        idx_all.append(np.stack([base, base + 1, base + PATCH, base + PATCH + 1], -1))
        w_all.append(
            np.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], -1)
        )
    return (np.concatenate(idx_all).astype(np.int32),
            np.concatenate(w_all).astype(np.float32))


_FAMILIES = {   # pattern, blur levels, (descriptor pairs, orientation pairs)
    "brisk": (_BRISK_XY, _BRISK_LV, _BRISK_SHORT, _BRISK_LONG),
    "freak": (_FREAK_XY, _FREAK_LV, _FREAK_DESC_PAIRS, _FREAK_ORI_PAIRS),
}


def _blur_kernels() -> list[list[float]]:
    """The three Gaussian taps of BLUR_SIGMAS, rounded to f32 as the reference's."""
    out = []
    for sig in BLUR_SIGMAS:
        r = max(int(math.ceil(2.5 * sig)), 1)
        x = np.arange(-r, r + 1)
        k1 = np.exp(-0.5 * (x / sig) ** 2)
        out.append([float(v) for v in (k1 / k1.sum()).astype(np.float32)])
    return out


_BLURS = _blur_kernels()


@functools.lru_cache(maxsize=None)
def _consts(family: str, device: torch.device) -> dict:
    """A family's tap banks (upright and rotated; the weights bf16-rounded,
    as the reference's bank), pair indices and pattern on ``device``,
    uploaded once (an upload per frame would be a synchronising copy)."""
    xy, lv, desc_pairs, ori_pairs = _FAMILIES[family]
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    out = {"xy": t(xy)}
    for name, n_rot in (("up", 1), ("rot", N_ROT)):
        idx, w = _pattern_tap_bank(xy, lv, n_rot)
        out[f"idx_{name}"] = t(idx.astype(np.int64))
        out[f"w_{name}"] = _bf16(t(w))
    out["di"], out["dj"] = t(desc_pairs[:, 0].astype(np.int64)), t(desc_pairs[:, 1].astype(np.int64))
    out["oi"], out["oj"] = t(ori_pairs[:, 0].astype(np.int64)), t(ori_pairs[:, 1].astype(np.int64))
    return out


def _sample_pattern(img: torch.Tensor, kp: ScaleKeypoints, family: str,
                    abin: torch.Tensor | None):
    """Sample every pattern point of every keypoint: (N, K) intensities and
    validity.  Each keypoint samples its own octave's 32x32 window, each
    point from the blur level of its smoothing; ``abin`` (N,) selects the
    pre-rotated pattern (None: upright).  One stacked patch gather an
    octave."""
    c = _consts(family, img.device)
    N = kp.pts.shape[0]
    K = c["xy"].shape[0]
    pk = torch.arange(K, device=img.device)
    if abin is None:
        idx, w = c["idx_up"].expand(N, K, 4), c["w_up"].expand(N, K, 4)
    else:
        rows = abin.to(torch.int64)[:, None] * K + pk                # (N, K)
        idx, w = c["idx_rot"][rows], c["w_rot"][rows]                # (N, K, 4)
    idx = idx.reshape(N, K * 4)

    out = torch.zeros((N, K), dtype=torch.float32, device=img.device)
    valid = torch.zeros((N,), dtype=torch.bool, device=img.device)
    level = img
    for o in range(N_OCTAVES):
        H, W = level.shape
        if H < PATCH or W < PATCH:
            # octave smaller than the sampling patch: its keypoints stay invalid
            break
        stack = torch.stack([_sep_conv(level, k1, k1) for k1 in _BLURS])   # (3, H, W)
        xy = (kp.pts + 0.5) / (2.0 ** o) - 0.5
        corner = torch.round(xy).to(torch.int32) - PATCH // 2
        inside = ((corner[:, 0] >= 0) & (corner[:, 0] <= W - PATCH)
                  & (corner[:, 1] >= 0) & (corner[:, 1] <= H - PATCH))
        corner = torch.stack([torch.clamp(corner[:, 0], 0, W - PATCH),
                              torch.clamp(corner[:, 1], 0, H - PATCH)], dim=-1)
        patches = gather_patches_stack(stack, corner, PATCH)                # (3, N, P, P)
        v = sample_taps(patches.transpose(0, 1).reshape(N, 3 * PATCH * PATCH), idx, w)
        sel = kp.octave == o
        out = torch.where(sel[:, None], v, out)
        valid = torch.where(sel, inside, valid)
        level = _sep_conv(level, _G5, _G5)[::2, ::2]
    return out, valid & kp.mask


def _orientation_bins(img: torch.Tensor, kp: ScaleKeypoints, family: str):
    """(N,) int64 rotation bin of each keypoint's upright-pattern gradient,
    and the upright pass's validity: BRISK's long-pair gradient (the paper's
    local-gradient sum), FREAK's symmetric-pair gradient."""
    c = _consts(family, img.device)
    vals, valid = _sample_pattern(img, kp, family, None)
    i, j = c["oi"], c["oj"]
    if family == "brisk":
        dxy = c["xy"][j] - c["xy"][i]                                 # (L, 2)
        g = ((vals[:, j] - vals[:, i]) / torch.clamp(torch.sum(dxy * dxy, -1), min=1e-9)) @ dxy
    else:
        dxy = c["xy"][i] - c["xy"][j]
        dxy = dxy / torch.clamp(torch.sqrt(torch.sum(dxy * dxy, -1, keepdim=True)), min=1e-9)
        g = (vals[:, i] - vals[:, j]) @ dxy
    angle = torch.atan2(g[:, 1], g[:, 0])
    abin = torch.remainder(torch.round(angle * (N_ROT / (2.0 * math.pi))).to(torch.int64), N_ROT)
    return abin, valid


def _descriptors(img: torch.Tensor, kp: ScaleKeypoints, family: str):
    """Two sampling passes: upright for the orientation, then rotated by its
    bin for the 512 pair comparisons."""
    c = _consts(family, img.device)
    abin, valid = _orientation_bins(img, kp, family)
    vals_r, valid_r = _sample_pattern(img, kp, family, abin)
    bits = vals_r[:, c["di"]] < vals_r[:, c["dj"]]
    return pack_bits(bits), valid & valid_r


def brisk_descriptors(img: torch.Tensor, kp: ScaleKeypoints):
    """(N, 16) int32 BRISK descriptors + validity."""
    return _descriptors(img, kp, "brisk")


def freak_descriptors(img: torch.Tensor, kp: ScaleKeypoints):
    """(N, 16) int32 FREAK descriptors + validity (retinal pattern,
    symmetric-pair orientation, coarse-to-fine comparisons)."""
    return _descriptors(img, kp, "freak")
