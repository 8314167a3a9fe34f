"""AKAZE: nonlinear-diffusion scale space and the M-LDB binary descriptor
(port of ``vloam_tpu/ops/akaze.py``; the reference's
``DetectorType::AKAZE`` / ``DescriptorType::AKAZE``).

  * the nonlinear (Perona-Malik g2) scale space is evolved with a fixed
    number of explicit diffusion steps a sublevel, each two gradient passes
    and one divergence pass of wrapping rolls; the contrast factor k is 1.5x
    the mean gradient magnitude of the smoothed image;
  * detector: scale-normalised determinant-of-Hessian extrema a sublevel
    (8 spatial neighbours and the adjacent sublevels), per octave the
    ``max_keypoints // 4`` strongest (the reference's ``approx_max_k`` takes
    its exact CPU branch here: ``image_ops.top_k``);
  * descriptor: each keypoint's 32x32 window is cut from its octave's finest
    sublevel by the single-image patch gather (``patch_gather.
    gather_patches``, the CUDA kernel B2), once an octave; the orientation
    is the Gaussian-weighted gradient sum, snapped to 30 bins; (intensity,
    dx, dy) are sampled on the bin's rotated 24x24 grid
    (``image_ops.sample_taps``: the reference's bf16 product with its dense
    bank, ``akaze.py:272-276``, without the 70.8 MB bank); the cell
    means of the 2x2 / 3x3 / 4x4 grids are compared pairwise a channel:
    486 bits, zero-padded to 16 words of 32 (int32 words, see ``ops/orb``).

``orb.match_descriptors`` matches them (Hamming).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from vloam_tpu_torch.ops.image_ops import (_bf16, _sep_conv, border_mask, neighbour_max,
                                           sample_taps, top_k)
from vloam_tpu_torch.ops.orb import pack_bits
from vloam_tpu_torch.ops.patch_gather import gather_patches

N_OCTAVES = 4
N_SUB = 3                 # sublevels per octave
FED_STEPS = 6             # explicit diffusion steps per sublevel
TAU = 0.24                # explicit step size (stability bound 0.25)
PATCH = 32
GRID = 24                 # rotated sample grid for cell means (lcm-friendly)
N_ROT = 30                # pre-rotated sampling grids (ORB's 2pi/30 binning)
_G5 = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]


def _rot_bank_build() -> tuple[np.ndarray, np.ndarray]:
    """Bilinear tap tables of the N_ROT pre-rotated GRIDxGRID sample grids:
    (idx (N_ROT*GRID^2, 4) int32 flat patch indices, w (N_ROT*GRID^2, 4)
    float32 bilinear weights)."""
    u = (np.arange(GRID, dtype=np.float64) + 0.5) / GRID - 0.5
    gu, gv = np.meshgrid(u, u, indexing="xy")
    gu, gv = gu.reshape(-1), gv.reshape(-1)
    span = PATCH * 0.75
    idx_all, w_all = [], []
    for b in range(N_ROT):
        th = b * 2.0 * np.pi / N_ROT
        c, s = np.cos(th), np.sin(th)
        px = (c * gu - s * gv) * span + (PATCH - 1) / 2.0
        py = (s * gu + c * gv) * span + (PATCH - 1) / 2.0
        x0 = np.clip(np.floor(px), 0, PATCH - 2).astype(np.int64)
        y0 = np.clip(np.floor(py), 0, PATCH - 2).astype(np.int64)
        fx = np.clip(px - x0, 0.0, 1.0)
        fy = np.clip(py - y0, 0.0, 1.0)
        base = y0 * PATCH + x0
        idx_all.append(np.stack([base, base + 1, base + PATCH, base + PATCH + 1], -1))
        w_all.append(
            np.stack([(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], -1)
        )
    return (np.concatenate(idx_all).astype(np.int32),
            np.concatenate(w_all).astype(np.float32))


class AkazeKeypoints(NamedTuple):
    pts: torch.Tensor        # (N, 2) full-res xy
    mask: torch.Tensor
    response: torch.Tensor
    octave: torch.Tensor     # (N,) int32
    angle: torch.Tensor      # (N,) radians


def _grad(x: torch.Tensor):
    """Central differences along the last two dims (wrapping)."""
    gx = 0.5 * (torch.roll(x, -1, -1) - torch.roll(x, 1, -1))
    gy = 0.5 * (torch.roll(x, -1, -2) - torch.roll(x, 1, -2))
    return gx, gy


def _diffuse(x: torch.Tensor, k2: torch.Tensor, steps: int) -> torch.Tensor:
    """Explicit Perona-Malik g2 diffusion: x += tau * div(g grad x)."""
    for _ in range(steps):
        gx, gy = _grad(x)
        g = 1.0 / (1.0 + (gx * gx + gy * gy) / k2)
        fx, fy = g * gx, g * gy
        div = (0.5 * (torch.roll(fx, -1, 1) - torch.roll(fx, 1, 1))
               + 0.5 * (torch.roll(fy, -1, 0) - torch.roll(fy, 1, 0)))
        x = x + TAU * div
    return x


def nonlinear_scale_space(img: torch.Tensor) -> list[torch.Tensor]:
    """[(N_SUB, H_o, W_o)] per octave of diffused images."""
    base = _sep_conv(img, _G5, _G5)
    # contrast factor from the smoothed gradient (1.5x the mean magnitude)
    gx, gy = _grad(base)
    k = 1.5 * torch.mean(torch.sqrt(gx * gx + gy * gy)) + 1e-6
    k2 = k * k
    octaves = []
    x = base
    for _ in range(N_OCTAVES):
        subs = []
        for _ in range(N_SUB):
            x = _diffuse(x, k2, FED_STEPS)
            subs.append(x)
        octaves.append(torch.stack(subs))
        x = x[::2, ::2]
    return octaves


def _hessian_response(x: torch.Tensor) -> torch.Tensor:
    """Determinant of the Hessian of each (H, W) slice of (..., H, W)."""
    dxx = torch.roll(x, -1, -1) + torch.roll(x, 1, -1) - 2 * x
    dyy = torch.roll(x, -1, -2) + torch.roll(x, 1, -2) - 2 * x
    dxy = 0.25 * (torch.roll(x, (-1, -1), (-2, -1)) + torch.roll(x, (1, 1), (-2, -1))
                  - torch.roll(x, (-1, 1), (-2, -1)) - torch.roll(x, (1, -1), (-2, -1)))
    return dxx * dyy - dxy * dxy


def detect(img: torch.Tensor, max_keypoints: int = 1024,
           threshold: float = 1e-3) -> AkazeKeypoints:
    octs = nonlinear_scale_space(img)
    per_oct = max_keypoints // N_OCTAVES
    dev = img.device
    pts, msk, rsp, ocs = [], [], [], []
    for o, subs in enumerate(octs):
        # scale normalisation (sigma^4 for det-of-Hessian; sigma ~ 2^o)
        resp = _hessian_response(subs) * float((2 ** o) ** 4)        # (N_SUB, H, W)
        L, H, W = resp.shape
        is_peak = (resp > neighbour_max(resp)) & (resp > threshold)
        # adjacent sublevels (centre pixels)
        ninf = torch.full_like(resp[:1], -torch.inf)
        is_peak = (is_peak & (resp > torch.cat([resp[1:], ninf]))
                   & (resp > torch.cat([ninf, resp[:-1]])))
        is_peak = is_peak & border_mask(H, W, PATCH // 2 + 1, dev)
        top, idx = top_k(torch.where(is_peak, resp, 0.0).reshape(-1), per_oct)
        rem = idx % (H * W)
        x = (rem % W).to(torch.float32)
        y = (rem // W).to(torch.float32)
        sf = float(2 ** o)
        pts.append(torch.stack([(x + 0.5) * sf - 0.5, (y + 0.5) * sf - 0.5], dim=-1))
        msk.append(top > 0.0)
        rsp.append(top)
        ocs.append(torch.full((per_oct,), o, dtype=torch.int32, device=dev))
    n = per_oct * N_OCTAVES
    return AkazeKeypoints(torch.cat(pts), torch.cat(msk), torch.cat(rsp), torch.cat(ocs),
                          torch.zeros((n,), dtype=torch.float32, device=dev))


def _ldb_pairs() -> np.ndarray:
    """(162, 2) cell-index pairs across the stacked 2x2|3x3|4x4 grids
    (cells 0-3, 4-12, 13-28): all within-grid pairs."""
    pairs = []
    off = 0
    for g in (2, 3, 4):
        n = g * g
        for i in range(n):
            for j in range(i + 1, n):
                pairs.append((off + i, off + j))
        off += n
    return np.array(pairs, np.int32)


_PAIRS = _ldb_pairs()


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    """The orientation window, the rotated sampling bank (weights
    bf16-rounded, as the reference's bank) and the cell pairs on
    ``device``, uploaded once."""
    ax = torch.arange(PATCH, dtype=torch.float32, device=device) - (PATCH - 1) / 2.0
    idx, w = _rot_bank_build()
    return {
        "ori_w": torch.exp(-(ax[None, :] ** 2 + ax[:, None] ** 2) / (2 * (PATCH / 5.0) ** 2)),
        "idx": torch.tensor(idx.astype(np.int64), device=device),
        "w": _bf16(torch.tensor(w, device=device)),
        "ii": torch.tensor(_PAIRS[:, 0].astype(np.int64), device=device),
        "jj": torch.tensor(_PAIRS[:, 1].astype(np.int64), device=device),
    }


def describe(img: torch.Tensor, kp: AkazeKeypoints):
    """(N, 16) int32 M-LDB descriptors + validity + oriented keypoints."""
    octs = nonlinear_scale_space(img)
    c = _consts(img.device)
    N = kp.pts.shape[0]

    # --- patches at each keypoint's octave (finest sublevel) ---------------
    patches = torch.zeros((N, PATCH, PATCH), dtype=torch.float32, device=img.device)
    valid = torch.zeros((N,), dtype=torch.bool, device=img.device)
    for o, subs in enumerate(octs):
        H, W = subs.shape[1:]
        if H < PATCH or W < PATCH:
            break
        xy = (kp.pts + 0.5) / (2.0 ** o) - 0.5
        corner = torch.round(xy).to(torch.int32) - PATCH // 2
        inside = ((corner[:, 0] >= 0) & (corner[:, 0] <= W - PATCH)
                  & (corner[:, 1] >= 0) & (corner[:, 1] <= H - PATCH))
        corner = torch.stack([torch.clamp(corner[:, 0], 0, W - PATCH),
                              torch.clamp(corner[:, 1], 0, H - PATCH)], dim=-1)
        p = gather_patches(subs[0], corner, PATCH)
        sel = kp.octave == o
        patches = torch.where(sel[:, None, None], p, patches)
        valid = torch.where(sel, inside, valid)
    valid = valid & kp.mask
    gx, gy = _grad(patches)

    # --- orientation: Gaussian-weighted gradient sum, snapped to N_ROT bins -
    sx = torch.sum(gx * c["ori_w"], dim=(1, 2))
    sy = torch.sum(gy * c["ori_w"], dim=(1, 2))
    angle = torch.atan2(sy, sx)
    abin = torch.remainder(torch.round(angle * (N_ROT / (2.0 * math.pi))).to(torch.int64), N_ROT)
    angle_q = abin.to(torch.float32) * (2.0 * math.pi / N_ROT)
    kp = kp._replace(angle=angle_q)

    # --- (intensity, dx, dy) on the bin's rotated grid ----------------------
    G2 = GRID * GRID
    rows = abin[:, None] * G2 + torch.arange(G2, device=img.device)       # (N, G2)
    idx, w = c["idx"][rows].reshape(N, G2 * 4), c["w"][rows]

    si, sgx, sgy = (sample_taps(f.reshape(N, PATCH * PATCH), idx, w).reshape(N, GRID, GRID)
                    for f in (patches, gx, gy))
    cs, sn = torch.cos(angle_q), torch.sin(angle_q)
    # rotate gradients into the keypoint frame
    rgx = cs[:, None, None] * sgx + sn[:, None, None] * sgy
    rgy = -sn[:, None, None] * sgx + cs[:, None, None] * sgy

    # --- cell means for 2x2 / 3x3 / 4x4 grids, compared pairwise -----------
    def cell_means(f, g):
        return f.reshape(N, g, GRID // g, g, GRID // g).mean(dim=(2, 4)).reshape(N, g * g)

    bits = []
    for ch in (si, rgx, rgy):
        f = torch.cat([cell_means(ch, 2), cell_means(ch, 3), cell_means(ch, 4)], dim=1)
        bits.append(f[:, c["ii"]] > f[:, c["jj"]])                         # (N, 162)
    bits = torch.cat(bits, dim=1)                                          # (N, 486)
    bits = torch.nn.functional.pad(bits, (0, 512 - bits.shape[1]))
    return pack_bits(bits), valid, kp


def akaze_features(img: torch.Tensor, max_keypoints: int = 1024, threshold: float = 1e-3):
    """Detect + describe.  Returns (keypoints, (N, 16) int32, valid)."""
    kp = detect(img, max_keypoints, threshold)
    desc, valid, kp = describe(img, kp)
    return kp, desc, valid
