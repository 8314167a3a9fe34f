"""SIFT: DoG scale-space detector and 128-d gradient-histogram descriptor
(port of ``vloam_tpu/ops/sift.py``; the reference's ``DetectorType::SIFT``
/ ``DescriptorType::SIFT`` and its FLANN float matcher).

  * the Gaussian pyramid is S + 3 separable blurs an octave, 4 octaves;
  * keypoints: 26-neighbourhood extrema of the DoG stack, scored by |DoG|
    with a Hessian edge gate, per octave the ``max_keypoints // 4``
    strongest (the reference's ``approx_max_k`` takes its exact CPU branch
    here: ``image_ops.top_k``);
  * orientation and descriptor: each keypoint's 24x24 window is cut from
    its octave's middle Gaussian level by the single-image patch gather
    (``patch_gather.gather_patches`` at P = 24, the CUDA kernel B2), once an
    octave; the dominant orientation is the peak of a 36-bin histogram, and
    the rotated 16x16 gradient grid is sampled from the bank of the 36
    orientation-bin rotations (``image_ops.sample_taps``: the reference's
    bf16 product, ``sift.py:271-275``, as a four-tap gather) and
    soft-binned into the classic 4x4x8 histogram;
  * matching: exact L2 (2-NN ratio test or mutual NN), or the FLANN
    stand-in: a random projection to 32 dimensions prefilters 8 candidates,
    exact L2 re-ranks them.

The projection is ``jax.random.normal(PRNGKey(0), (128, 32)) / sqrt(32)``
in the reference.  NumPy cannot draw JAX's threefry stream, so the one
matrix the port uses (seed 0, 32 dimensions) is a constant of its own,
``sift_flann_proj.npy`` beside this module, held bit-equal to JAX's draw by
the tests.  Other seeds or widths raise.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple

import numpy as np
import torch

from vloam_tpu_torch.ops.image_ops import _bf16, _sep_conv, border_mask, sample_taps, top_k
from vloam_tpu_torch.ops.orb import MASKED, _first_argmin, _two_smallest
from vloam_tpu_torch.ops.patch_gather import gather_patches

N_OCTAVES = 4
S = 3                      # intra-octave scales; 5 DoG levels, 3 searchable
SIGMA0 = 1.6
EDGE_R = 10.0              # Hessian edge-ratio gate (Lowe's r=10)
PATCH = 24                 # descriptor support patch (octave pixels)
DESC_GRID = 16             # sample grid for the 4x4x8 histogram
N_ORI = 36                 # orientation histogram bins
FLANN_PROJ_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sift_flann_proj.npy")
FLANN_PROJ_SEED, FLANN_PROJ_DIM = 0, 32


class SiftKeypoints(NamedTuple):
    pts: torch.Tensor          # (N, 2) full-resolution xy
    mask: torch.Tensor         # (N,)
    response: torch.Tensor     # (N,) |DoG|
    octave: torch.Tensor       # (N,) int32
    level: torch.Tensor        # (N,) int32 DoG level within octave (1..S)
    angle: torch.Tensor        # (N,) radians (0 until oriented)


def _gauss_kernel(sigma: float) -> list[float]:
    r = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return [float(v) for v in (k / k.sum()).astype(np.float32)]


def gaussian_octaves(img: torch.Tensor) -> list[torch.Tensor]:
    """[(S+3, H_o, W_o)] per octave: incremental Gaussian blurs."""
    octaves = []
    base = img
    # incremental sigmas: level k has total sigma SIGMA0 * 2^(k/S)
    inc = [SIGMA0 * (2.0 ** ((k + 1) / S)) * math.sqrt(1.0 - 2.0 ** (-2.0 / S))
           for k in range(S + 2)]
    g0 = _gauss_kernel(SIGMA0)
    for _ in range(N_OCTAVES):
        levels = [_sep_conv(base, g0, g0)]
        for k in range(S + 2):
            g = _gauss_kernel(inc[k])
            levels.append(_sep_conv(levels[-1], g, g))
        octaves.append(torch.stack(levels))
        base = levels[S][::2, ::2]       # the 2x-sigma level seeds the next octave
    return octaves


def _shift_minmax(x: torch.Tensor):
    """Minimum and maximum over the 8 wrapping neighbours (the centre pixel
    excluded) in the last two dims."""
    mn = torch.full_like(x, torch.inf)
    mx = torch.full_like(x, -torch.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                r = torch.roll(x, (dy, dx), (1, 2))
                mn = torch.minimum(mn, r)
                mx = torch.maximum(mx, r)
    return mn, mx


def _extrema_scores(dog: torch.Tensor, contrast_thresh: float) -> torch.Tensor:
    """dog: (L, H, W).  Scores |dog| at 26-neighbourhood extrema of the
    middle levels, 0 elsewhere.  Returns (L-2, H, W)."""
    mn, mx = _shift_minmax(dog)
    c = dog[1:-1]
    # extremum vs the 8 spatial neighbours at own level, and the 9 cells
    # (8 neighbours + centre) of the levels above and below
    is_max = ((c > mx[1:-1]) & (c >= mx[:-2]) & (c >= mx[2:])
              & (c > dog[:-2]) & (c > dog[2:]))
    is_min = ((c < mn[1:-1]) & (c <= mn[:-2]) & (c <= mn[2:])
              & (c < dog[:-2]) & (c < dog[2:]))
    # Hessian edge gate on the centre level
    dxx = torch.roll(c, -1, 2) + torch.roll(c, 1, 2) - 2 * c
    dyy = torch.roll(c, -1, 1) + torch.roll(c, 1, 1) - 2 * c
    dxy = 0.25 * (torch.roll(c, (-1, -1), (1, 2)) + torch.roll(c, (1, 1), (1, 2))
                  - torch.roll(c, (-1, 1), (1, 2)) - torch.roll(c, (1, -1), (1, 2)))
    tr, det = dxx + dyy, dxx * dyy - dxy * dxy
    edge_ok = (det > 0) & (tr * tr / torch.clamp(det, min=1e-12) < (EDGE_R + 1) ** 2 / EDGE_R)
    strong = torch.abs(c) > contrast_thresh
    return torch.where((is_max | is_min) & edge_ok & strong, torch.abs(c), 0.0)


def detect(img: torch.Tensor, max_keypoints: int = 1024,
           contrast_thresh: float = 1.0) -> SiftKeypoints:
    """DoG keypoints with a fixed total budget (per-octave top-k)."""
    octs = gaussian_octaves(img)
    per_oct = max_keypoints // N_OCTAVES
    dev = img.device
    pts, msk, rsp, ocs, lvs = [], [], [], [], []
    for o, g in enumerate(octs):
        sc = _extrema_scores(g[1:] - g[:-1], contrast_thresh)   # (S, H, W)
        L, H, W = sc.shape
        # exclude borders (descriptor support)
        sc = torch.where(border_mask(H, W, PATCH // 2 + 1, dev), sc, 0.0)
        top, idx = top_k(sc.reshape(-1), per_oct)
        lvl = idx // (H * W)
        rem = idx % (H * W)
        x = (rem % W).to(torch.float32)
        y = (rem // W).to(torch.float32)
        scale_f = float(2 ** o)
        pts.append(torch.stack([(x + 0.5) * scale_f - 0.5, (y + 0.5) * scale_f - 0.5], dim=-1))
        msk.append(top > 0.0)
        rsp.append(top)
        ocs.append(torch.full((per_oct,), o, dtype=torch.int32, device=dev))
        lvs.append(lvl.to(torch.int32) + 1)
    return SiftKeypoints(
        pts=torch.cat(pts), mask=torch.cat(msk), response=torch.cat(rsp),
        octave=torch.cat(ocs), level=torch.cat(lvs),
        angle=torch.zeros((per_oct * N_OCTAVES,), dtype=torch.float32, device=dev),
    )


def _patch_grads(patch: torch.Tensor):
    """Central-difference gradients of (N, P, P) patches (wrapping)."""
    gx = 0.5 * (torch.roll(patch, -1, 2) - torch.roll(patch, 1, 2))
    gy = 0.5 * (torch.roll(patch, -1, 1) - torch.roll(patch, 1, 1))
    return gx, gy


def _gather_patches_multi_octave(octs, kp: SiftKeypoints) -> torch.Tensor:
    """(N, PATCH, PATCH) patches, each cut from its keypoint's octave's
    middle Gaussian level: one single-image gather an octave, every keypoint
    at every octave, each keeping its own."""
    N = kp.pts.shape[0]
    out = torch.zeros((N, PATCH, PATCH), dtype=torch.float32, device=kp.pts.device)
    for o, g in enumerate(octs):
        H, W = g.shape[1:]
        xy = (kp.pts + 0.5) / (2.0 ** o) - 0.5
        corner = torch.round(xy).to(torch.int32) - PATCH // 2
        corner = torch.stack([torch.clamp(corner[:, 0], 0, W - PATCH),
                              torch.clamp(corner[:, 1], 0, H - PATCH)], dim=-1)
        # the middle Gaussian level stands in for each keypoint's own level:
        # the descriptor is normalised, so the residual blur difference washes out
        p = gather_patches(g[S // 2 + 1], corner, PATCH)
        out = torch.where((kp.octave == o)[:, None, None], p, out)
    return out


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    """The orientation window, the descriptor's grid weights and the rotated
    sampling bank on ``device``, uploaded once."""
    ax = torch.arange(PATCH, dtype=torch.float32, device=device) - (PATCH - 1) / 2.0
    u = (torch.arange(DESC_GRID, dtype=torch.float32, device=device) + 0.5) / DESC_GRID - 0.5
    gv, gu = torch.meshgrid(u, u, indexing="ij")          # rows are y: meshgrid "xy"
    cell = (torch.arange(DESC_GRID, dtype=torch.float32, device=device) + 0.5) / DESC_GRID * 4.0 - 0.5
    centers = torch.arange(4, dtype=torch.float32, device=device)
    idx, w = _sift_rot_bank()
    return {
        "ori_w": torch.exp(-(ax[None, :] ** 2 + ax[:, None] ** 2) / (2 * (0.5 * PATCH / 3) ** 2)),
        "bins": torch.arange(N_ORI, device=device),
        "grid_w": torch.exp(-(gu ** 2 + gv ** 2) / (2 * 0.25)),
        "tent": torch.clamp(1.0 - torch.abs(cell[:, None] - centers[None, :]), min=0.0),
        "obins": torch.arange(8, dtype=torch.float32, device=device),
        "idx": torch.tensor(idx.astype(np.int64), device=device),
        "w": _bf16(torch.tensor(w, device=device)),
    }


def orient(octs, kp: SiftKeypoints) -> SiftKeypoints:
    """Dominant gradient orientation (36-bin histogram, Gaussian weighted)."""
    c = _consts(kp.pts.device)
    patches = _gather_patches_multi_octave(octs, kp)
    gx, gy = _patch_grads(patches)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)                                # [-pi, pi]
    bins = torch.remainder(torch.floor((ang / (2 * math.pi) + 0.5) * N_ORI).to(torch.int64), N_ORI)
    wmag = (mag * c["ori_w"]).reshape(mag.shape[0], -1)      # (N, P*P)
    onehot = bins.reshape(mag.shape[0], -1, 1) == c["bins"]  # (N, P*P, 36)
    hist = torch.sum(torch.where(onehot, wmag[..., None], 0.0), dim=1)
    peak = torch.argmax(hist, dim=-1)                        # the first maximum, as jnp.argmax
    angle = (peak.to(torch.float32) + 0.5) / N_ORI * 2 * math.pi - math.pi
    return kp._replace(angle=angle)


def _sift_rot_bank() -> tuple[np.ndarray, np.ndarray]:
    """Bilinear tap tables of the 36 pre-rotated DESC_GRID^2 sample grids.

    SIFT's orientation is already the peak of a 36-bin histogram (see
    ``orient``), so snapping the sampling rotation to those same 36 bin
    centres loses nothing."""
    u = (np.arange(DESC_GRID, dtype=np.float64) + 0.5) / DESC_GRID - 0.5
    gu, gv = np.meshgrid(u, u, indexing="xy")
    gu, gv = gu.reshape(-1), gv.reshape(-1)
    span = PATCH * 0.8
    idx_all, w_all = [], []
    for b in range(36):
        th = (b + 0.5) / 36.0 * 2.0 * np.pi - np.pi   # the orient() centres
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


def describe(octs, kp: SiftKeypoints):
    """128-d descriptors: rotated 16x16 gradient samples soft-binned 4x4x8."""
    c = _consts(kp.pts.device)
    patches = _gather_patches_multi_octave(octs, kp)
    gx, gy = _patch_grads(patches)
    N = kp.pts.shape[0]
    G2 = DESC_GRID * DESC_GRID

    # the rotated sample grid: the bank rows of each keypoint's orientation bin
    cs, sn = torch.cos(kp.angle), torch.sin(kp.angle)
    abin = torch.remainder(
        torch.round((kp.angle + math.pi) / (2.0 * math.pi) * 36.0 - 0.5).to(torch.int64), 36)
    rows = abin[:, None] * G2 + torch.arange(G2, device=abin.device)        # (N, G2)
    idx, w = c["idx"][rows].reshape(N, G2 * 4), c["w"][rows]               # (N, G2 * 4), (N, G2, 4)

    sgx, sgy = (sample_taps(f.reshape(N, PATCH * PATCH), idx, w).reshape(N, DESC_GRID, DESC_GRID)
                for f in (gx, gy))
    # rotate gradients into the keypoint frame
    rgx = cs[:, None, None] * sgx + sn[:, None, None] * sgy
    rgy = -sn[:, None, None] * sgx + cs[:, None, None] * sgy
    mag = torch.sqrt(rgx * rgx + rgy * rgy)
    ang = torch.atan2(rgy, rgx)
    mag = mag * c["grid_w"][None]

    # soft binning: spatial tent into 4x4 cells, orientation tent into 8 bins
    ob = (ang / (2 * math.pi) + 0.5) * 8.0 - 0.5                           # (N, G, G)
    d = torch.abs(ob[..., None] - c["obins"])
    wo = torch.clamp(1.0 - torch.minimum(d, 8.0 - d), min=0.0)            # circular tent (N,G,G,8)
    tent = c["tent"]                                                       # (G, 4), y and x alike
    desc = torch.einsum("nyxo,yr,xc->nrco", wo * mag[..., None], tent, tent).reshape(N, 128)
    # normalise, clip, renormalise (Lowe's illumination robustness)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-9)
    desc = torch.clamp(desc, max=0.2)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-9)
    return desc, kp.mask


def sift_features(img: torch.Tensor, max_keypoints: int = 1024, contrast_thresh: float = 1.0):
    """Detect + orient + describe in one call.  Returns (keypoints, (N, 128))."""
    octs = gaussian_octaves(img)
    kp = detect(img, max_keypoints, contrast_thresh)
    kp = orient(octs, kp)
    desc, _ = describe(octs, kp)
    return kp, desc


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a-b|^2 = |a|^2 + |b|^2 - 2 a.b, one (N0, N1) product."""
    return torch.sum(a * a, 1)[:, None] + torch.sum(b * b, 1)[None, :] - 2.0 * a @ b.T


def match_float_descriptors(desc0, mask0, desc1, mask1, ratio: float = 0.8,
                            select: str = "knn"):
    """L2 matching for float descriptors (SIFT).  ``select`` as in
    ``orb.match_descriptors``: "knn" = 2-NN + Lowe ratio, "nn" = mutual NN;
    ties go to the lower index.  Returns (match_idx (N0,), valid (N0,))."""
    d2 = torch.where(mask1[None, :], _sq_dists(desc0, desc1), MASKED)
    if select == "nn":
        d2 = torch.where(mask0[:, None], d2, MASKED)
        best, fwd = _first_argmin(d2, 1)
        _, bwd = _first_argmin(d2, 0)
        mutual = bwd[fwd] == torch.arange(desc0.shape[0], device=d2.device)
        return fwd, mask0 & mutual & (best < 1e8)
    best, second, idx = _two_smallest(d2)
    return idx, mask0 & (best < ratio * ratio * second) & (best < 1e8)


@functools.lru_cache(maxsize=None)
def _flann_projection(device: torch.device) -> torch.Tensor:
    return torch.tensor(np.load(FLANN_PROJ_FILE), device=device)


def match_float_descriptors_approx(desc0, mask0, desc1, mask1, ratio: float = 0.8,
                                   proj_dim: int = 32, rerank: int = 8, seed: int = 0):
    """The FLANN stand-in for float descriptors: distances in a ``proj_dim``
    random projection select ``rerank`` candidates per query (ties to the
    lower index, as ``lax.top_k``), exact L2 re-ranks only those."""
    if (seed, proj_dim) != (FLANN_PROJ_SEED, FLANN_PROJ_DIM) or desc0.shape[1] != 128:
        raise ValueError(
            f"match_float_descriptors_approx: the port carries only the reference's projection "
            f"for seed {FLANN_PROJ_SEED}, proj_dim {FLANN_PROJ_DIM} and 128-d descriptors "
            f"({os.path.basename(FLANN_PROJ_FILE)}), not seed {seed}, proj_dim {proj_dim}, "
            f"{desc0.shape[1]}-d")
    P = _flann_projection(desc0.device)
    d2s = torch.where(mask1[None, :], _sq_dists(desc0 @ P, desc1 @ P), MASKED)
    cand = torch.sort(d2s, dim=1, stable=True).indices[:, :rerank]         # (N0, rerank)
    diff = desc0[:, None, :] - desc1[cand]                                 # (N0, rerank, D)
    d2 = torch.where(mask1[cand], torch.sum(diff * diff, dim=-1), MASKED)
    best, second, order = _two_smallest(d2)
    idx = torch.gather(cand, 1, order[:, None])[:, 0]
    return idx, mask0 & (best < ratio * ratio * second) & (best < 1e8)
