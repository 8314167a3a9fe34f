"""SIFT, plain: a DoG scale-space detector, a 36-bin dominant orientation, the
4x4x8 gradient-histogram descriptor and exact L2 matching (the reference
ImageUtil's ``DetectorType::SIFT`` / ``DescriptorType::SIFT`` with the
brute-force matcher, image_util.cpp:72-163, 347-438), for the benchmark's
comparison.  Plain PyTorch, float32; the windows are cut with
``plainref.ops.patch_gather``'s plain gather, and every constant (the blur
taps, the orientation window, the grid weights, the 36-rotation sampling
bank) is computed here.

What follows Lowe (IJCV 2004): S = 3 scales an octave on S + 3 Gaussian
levels (sigma0 = 1.6, each level 2^(1/S) blurrier, incremental blurs), the
next octave seeded by the 2x-sigma level taken every other pixel; keypoints
at strict extrema of the 26-neighbourhood in the DoG stack that pass the
Hessian edge test with r = 10; the orientation as the peak of a 36-bin
histogram of gradient magnitudes under a Gaussian window; the descriptor as
16 cells of 8 orientation bins over a grid rotated to that orientation,
trilinearly soft-binned, normalised, clipped at 0.2 and normalised again;
matching by the nearest neighbour with the 0.8 ratio of squared distances
to the second (``select="knn"``) or by mutual nearest neighbours
(``select="nn"``), ties to the lower index.

Where it departs, as the configuration states (``assumed``):

* 4 octaves and no doubled base image;
* the contrast threshold is 1.0 on the DoG of the image as the step gets it
  (grey levels in [0, 255]), not 0.04 / S on a [0, 1] image;
* each octave keeps its ``max_keypoints // 4`` strongest extrema (by |DoG|,
  ties to the lower index), not every extremum over a threshold, and none
  within 13 pixels of the octave's border;
* a keypoint's window is cut from its octave's middle Gaussian level, not
  from its own level;
* no sub-pixel or sub-scale refinement: a keypoint sits at its pixel's
  centre;
* the orientation and the descriptor read a 24x24 window (octave pixels) of
  central-difference gradients that wrap at the window's edge; the
  descriptor samples a 16x16 grid spanning 0.8 of the window, rotated to the
  centre of the keypoint's orientation bin and read by bilinear taps whose
  values and weights are rounded to bfloat16 (the reference's bf16 product,
  summed in float32 as ``plainref.ops.image_ops.sample_taps`` does).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from plainref.ops.image_ops import _bf16, _sep_conv, border_mask, sample_taps, top_k
from plainref.ops.orb import MASKED, _first_argmin, _two_smallest
from plainref.ops.patch_gather import gather_patches

N_OCTAVES = 4
S = 3                  # scales an octave searched: S + 3 Gaussian levels, S + 2 DoG levels
SIGMA0 = 1.6
EDGE_R = 10.0
PATCH = 24             # the orientation's and the descriptor's window (octave pixels)
GRID = 16              # the descriptor's sample grid: 4x4 cells of 4x4 samples
N_ORI = 36             # orientation histogram bins
N_DESC_ORI = 8         # descriptor orientation bins
GRID_SPAN = 0.8        # the sample grid's extent, as a share of the window


class SiftKeypoints(NamedTuple):
    pts: torch.Tensor          # (N, 2) full-resolution (x, y)
    mask: torch.Tensor         # (N,)
    response: torch.Tensor     # (N,) |DoG|
    octave: torch.Tensor       # (N,) int32
    level: torch.Tensor        # (N,) int32 DoG level within the octave, 1..S
    angle: torch.Tensor        # (N,) radians, 0 until oriented


def _gauss_taps(sigma: float) -> list[float]:
    """A normalised Gaussian of radius max(ceil(3 sigma), 1), computed in
    float64 and rounded to float32."""
    r = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g = (g / g.sum()).astype(np.float32)
    return [float(v) for v in g]


def gaussian_octaves(img: torch.Tensor) -> list[torch.Tensor]:
    """One (S + 3, H_o, W_o) stack of Gaussian levels an octave; level k of
    every octave has blur SIGMA0 * 2^(k / S) in that octave's pixels."""
    # the blur that takes level k to level k + 1
    step = [SIGMA0 * 2.0 ** ((k + 1) / S) * math.sqrt(1.0 - 2.0 ** (-2.0 / S))
            for k in range(S + 2)]
    first = _gauss_taps(SIGMA0)
    octaves, base = [], img
    for _ in range(N_OCTAVES):
        levels = [_sep_conv(base, first, first)]
        for sigma in step:
            taps = _gauss_taps(sigma)
            levels.append(_sep_conv(levels[-1], taps, taps))
        octaves.append(torch.stack(levels))
        base = levels[S][::2, ::2]
    return octaves


def _neighbour_min_max(x: torch.Tensor):
    """The minimum and the maximum over each pixel's 8 neighbours (the pixel
    itself left out), wrapping at the edges, per level of (L, H, W)."""
    lo = torch.full_like(x, torch.inf)
    hi = torch.full_like(x, -torch.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            shifted = torch.roll(x, (dy, dx), (1, 2))
            lo = torch.minimum(lo, shifted)
            hi = torch.maximum(hi, shifted)
    return lo, hi


def _scores(dog: torch.Tensor, contrast: float) -> torch.Tensor:
    """(S, H, W): |DoG| where a middle level of the (S + 2, H, W) stack
    holds an extremum that passes the edge and contrast tests, else 0."""
    lo, hi = _neighbour_min_max(dog)
    mid, below, above = dog[1:-1], dog[:-2], dog[2:]
    # above every neighbour in its level, at least the neighbours of the
    # levels around it and above the pixel itself there; below likewise
    maximum = ((mid > hi[1:-1]) & (mid >= hi[:-2]) & (mid >= hi[2:])
               & (mid > below) & (mid > above))
    minimum = ((mid < lo[1:-1]) & (mid <= lo[:-2]) & (mid <= lo[2:])
               & (mid < below) & (mid < above))
    # the 2x2 Hessian of the level by central differences: Lowe's edge test
    # tr^2 / det < (r + 1)^2 / r with a positive determinant
    dxx = torch.roll(mid, -1, 2) + torch.roll(mid, 1, 2) - 2 * mid
    dyy = torch.roll(mid, -1, 1) + torch.roll(mid, 1, 1) - 2 * mid
    dxy = 0.25 * (torch.roll(mid, (-1, -1), (1, 2)) + torch.roll(mid, (1, 1), (1, 2))
                  - torch.roll(mid, (-1, 1), (1, 2)) - torch.roll(mid, (1, -1), (1, 2)))
    tr, det = dxx + dyy, dxx * dyy - dxy * dxy
    not_edge = (det > 0) & (tr * tr / torch.clamp(det, min=1e-12) < (EDGE_R + 1) ** 2 / EDGE_R)
    keep = (maximum | minimum) & not_edge & (torch.abs(mid) > contrast)
    return torch.where(keep, torch.abs(mid), 0.0)


def detect(img: torch.Tensor, max_keypoints: int = 1024,
           contrast_thresh: float = 1.0) -> SiftKeypoints:
    """The ``max_keypoints // N_OCTAVES`` strongest keypoints of each octave,
    octave by octave; a slot with no extremum left is masked out."""
    dev = img.device
    per_octave = max_keypoints // N_OCTAVES
    pts, mask, resp, octave, level = [], [], [], [], []
    for o, g in enumerate(gaussian_octaves(img)):
        sc = _scores(g[1:] - g[:-1], contrast_thresh)
        n_lvl, H, W = sc.shape
        sc = torch.where(border_mask(H, W, PATCH // 2 + 1, dev), sc, 0.0)
        top, flat = top_k(sc.reshape(-1), per_octave)
        pix = flat % (H * W)
        x = (pix % W).to(torch.float32)
        y = (pix // W).to(torch.float32)
        s = float(2 ** o)   # an octave-o pixel centre in full-resolution pixels
        pts.append(torch.stack([(x + 0.5) * s - 0.5, (y + 0.5) * s - 0.5], dim=-1))
        mask.append(top > 0.0)
        resp.append(top)
        octave.append(torch.full((per_octave,), o, dtype=torch.int32, device=dev))
        level.append((flat // (H * W)).to(torch.int32) + 1)
    n = per_octave * N_OCTAVES
    return SiftKeypoints(torch.cat(pts), torch.cat(mask), torch.cat(resp), torch.cat(octave),
                         torch.cat(level), torch.zeros((n,), dtype=torch.float32, device=dev))


def _windows(octs, kp: SiftKeypoints) -> torch.Tensor:
    """(N, PATCH, PATCH): each keypoint's window, centred on its pixel in its
    octave's middle Gaussian level and clamped inside that level."""
    out = torch.zeros((kp.pts.shape[0], PATCH, PATCH), dtype=torch.float32,
                      device=kp.pts.device)
    for o, g in enumerate(octs):
        H, W = g.shape[1:]
        at = torch.round((kp.pts + 0.5) / (2.0 ** o) - 0.5).to(torch.int32) - PATCH // 2
        corner = torch.stack([torch.clamp(at[:, 0], 0, W - PATCH),
                              torch.clamp(at[:, 1], 0, H - PATCH)], dim=-1)
        win = gather_patches(g[S // 2 + 1], corner, PATCH)
        out = torch.where((kp.octave == o)[:, None, None], win, out)
    return out


def _gradients(win: torch.Tensor):
    """Central differences of (N, P, P) windows, wrapping at their edges."""
    gx = 0.5 * (torch.roll(win, -1, 2) - torch.roll(win, 1, 2))
    gy = 0.5 * (torch.roll(win, -1, 1) - torch.roll(win, 1, 1))
    return gx, gy


def _sample_bank() -> tuple[np.ndarray, np.ndarray]:
    """The bilinear taps of the descriptor's sample grid rotated to the
    centre of each of the N_ORI orientation bins: (N_ORI * GRID^2, 4) indices
    into a flattened window and their weights, the grid's rows along y."""
    u = (np.arange(GRID, dtype=np.float64) + 0.5) / GRID - 0.5
    gx, gy = np.meshgrid(u, u, indexing="xy")
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    centre = (PATCH - 1) / 2.0
    idx, wts = [], []
    for b in range(N_ORI):
        th = (b + 0.5) / N_ORI * 2.0 * np.pi - np.pi
        c, s = np.cos(th), np.sin(th)
        px = (c * gx - s * gy) * (PATCH * GRID_SPAN) + centre
        py = (s * gx + c * gy) * (PATCH * GRID_SPAN) + centre
        x0 = np.clip(np.floor(px), 0, PATCH - 2).astype(np.int64)
        y0 = np.clip(np.floor(py), 0, PATCH - 2).astype(np.int64)
        fx = np.clip(px - x0, 0.0, 1.0)
        fy = np.clip(py - y0, 0.0, 1.0)
        at = y0 * PATCH + x0
        idx.append(np.stack([at, at + 1, at + PATCH, at + PATCH + 1], -1))
        wts.append(np.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], -1))
    return (np.concatenate(idx).astype(np.int32), np.concatenate(wts).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    """The orientation window, the descriptor's grid weights and cell tents
    and the rotated sample bank on ``device``, made once."""
    f32 = dict(dtype=torch.float32, device=device)
    ax = torch.arange(PATCH, **f32) - (PATCH - 1) / 2.0
    u = (torch.arange(GRID, **f32) + 0.5) / GRID - 0.5
    uy, ux = torch.meshgrid(u, u, indexing="ij")
    # a sample's position in cell units (cell centres at 0..3)
    cell = (torch.arange(GRID, **f32) + 0.5) / GRID * 4.0 - 0.5
    idx, wts = _sample_bank()
    return {
        # a Gaussian of sigma PATCH / 6 over the window
        "ori_window": torch.exp(-(ax[None, :] ** 2 + ax[:, None] ** 2)
                                / (2 * (0.5 * PATCH / 3) ** 2)),
        "ori_bins": torch.arange(N_ORI, device=device),
        # a Gaussian of sigma 0.5 over the grid's unit square
        "grid_window": torch.exp(-(ux ** 2 + uy ** 2) / (2 * 0.25)),
        "cell_tent": torch.clamp(1.0 - torch.abs(cell[:, None] - torch.arange(4, **f32)[None, :]),
                                 min=0.0),
        "desc_bins": torch.arange(N_DESC_ORI, **f32),
        "bank_idx": torch.tensor(idx.astype(np.int64), device=device),
        "bank_w": _bf16(torch.tensor(wts, device=device)),
    }


def orient(octs, kp: SiftKeypoints) -> SiftKeypoints:
    """Each keypoint's angle: the centre of the fullest bin (the first among
    equals) of its window's 36-bin histogram of Gaussian-weighted gradient
    magnitudes, in [-pi, pi)."""
    k = _consts(kp.pts.device)
    gx, gy = _gradients(_windows(octs, kp))
    n = gx.shape[0]
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)
    b = torch.remainder(torch.floor((ang / (2 * math.pi) + 0.5) * N_ORI).to(torch.int64), N_ORI)
    weight = (mag * k["ori_window"]).reshape(n, -1)
    in_bin = b.reshape(n, -1, 1) == k["ori_bins"]
    hist = torch.sum(torch.where(in_bin, weight[..., None], 0.0), dim=1)
    peak = torch.argmax(hist, dim=-1)
    return kp._replace(angle=(peak.to(torch.float32) + 0.5) / N_ORI * 2 * math.pi - math.pi)


def describe(octs, kp: SiftKeypoints):
    """(descriptors (N, 128) float32, valid (N,)): the 4x4 cells x 8 bins of
    gradient orientation relative to the keypoint's angle."""
    k = _consts(kp.pts.device)
    gx, gy = _gradients(_windows(octs, kp))
    n, g2 = gx.shape[0], GRID * GRID
    # the grid rotated to the centre of the keypoint's orientation bin
    b = torch.remainder(
        torch.round((kp.angle + math.pi) / (2.0 * math.pi) * N_ORI - 0.5).to(torch.int64), N_ORI)
    rows = b[:, None] * g2 + torch.arange(g2, device=b.device)
    idx = k["bank_idx"][rows].reshape(n, g2 * 4)
    w = k["bank_w"][rows]
    sx = sample_taps(gx.reshape(n, -1), idx, w).reshape(n, GRID, GRID)
    sy = sample_taps(gy.reshape(n, -1), idx, w).reshape(n, GRID, GRID)
    # the sampled gradients in the keypoint's frame
    c, s = torch.cos(kp.angle)[:, None, None], torch.sin(kp.angle)[:, None, None]
    rx = c * sx + s * sy
    ry = -s * sx + c * sy
    mag = torch.sqrt(rx * rx + ry * ry) * k["grid_window"][None]
    ang = torch.atan2(ry, rx)
    # a circular tent over the 8 orientation bins, a tent over the 4 cells
    # in y and in x
    d = torch.abs(((ang / (2 * math.pi) + 0.5) * N_DESC_ORI - 0.5)[..., None] - k["desc_bins"])
    w_ori = torch.clamp(1.0 - torch.minimum(d, N_DESC_ORI - d), min=0.0)
    tent = k["cell_tent"]
    desc = torch.einsum("nyxo,yr,xc->nrco", w_ori * mag[..., None], tent, tent).reshape(n, 128)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-9)
    desc = torch.clamp(desc, max=0.2)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-9)
    return desc, kp.mask


def match_float_descriptors(desc0, mask0, desc1, mask1, ratio: float = 0.8,
                            select: str = "knn"):
    """Exact L2 matching of each ``desc0`` row against ``desc1``: (match
    index (N0,), valid (N0,)).  Squared distances as |a|^2 + |b|^2 - 2 a.b;
    a masked candidate sits at MASKED."""
    d2 = (torch.sum(desc0 * desc0, 1)[:, None] + torch.sum(desc1 * desc1, 1)[None, :]
          - 2.0 * desc0 @ desc1.T)
    d2 = torch.where(mask1[None, :], d2, MASKED)
    if select == "nn":
        d2 = torch.where(mask0[:, None], d2, MASKED)
        best, fwd = _first_argmin(d2, 1)
        _, bwd = _first_argmin(d2, 0)
        mutual = bwd[fwd] == torch.arange(desc0.shape[0], device=d2.device)
        return fwd, mask0 & mutual & (best < 1e8)
    best, second, idx = _two_smallest(d2)
    return idx, mask0 & (best < ratio * ratio * second) & (best < 1e8)
