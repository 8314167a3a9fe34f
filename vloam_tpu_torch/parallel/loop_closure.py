"""Loop closure for the pose-graph back end (port of
``vloam_tpu/parallel/loop_closure.py``).

Three stages:

  1. ``detect_revisits``: host control plane, a proximity + temporal-gap +
     traveled-path gate over the estimated keyframe positions (NumPy, a copy
     of the reference's: it imports jax).
  2. ``register_loop``: align the two keyframes' feature clouds.  Seeds are
     the chain's relative estimate plus the best ``coarse_top_k`` peaks of an
     SE(2) occupancy correlation (``coarse_align``); all seeds are refined at
     once by ``models/lidar_odometry.solve_f2f_batched`` (one k-NN launch
     and one batched GN launch per outer iteration) and arbitrated by the
     tight-inlier fraction (``tight_inlier_frac``, one nearest-neighbour
     launch for every seed's sample).
  3. ``loop_factors``: accepted registrations as relative-pose factors for
     ``parallel/pose_graph``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from vloam_tpu_torch import geometry as geo
from vloam_tpu_torch.config import VloamConfig
from vloam_tpu_torch.models.lidar_odometry import solve_f2f_batched
from vloam_tpu_torch.ops.knn import nn1
from vloam_tpu_torch.ops.scan_registration import ScanFeatures
from vloam_tpu_torch.ops.voxel import div_exact
from vloam_tpu_torch.parallel.pose_graph import PoseGraphFactors


def path_cumlen(positions: np.ndarray) -> np.ndarray:
    """Cumulative traveled path length (m) along the keyframe chain: (N,)."""
    pos = np.asarray(positions, np.float64)
    seg = np.linalg.norm(np.diff(pos, axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(seg)])


def effective_radius(
    cum: np.ndarray, j: int, k: int, radius: float, drift_rate: float
) -> float:
    """Drift-aware proximity gate for the (j, k) pair: base ``radius`` plus
    ``drift_rate`` times the path traveled between the two keyframes."""
    return radius + drift_rate * float(cum[k] - cum[j])


def detect_revisits(
    positions: np.ndarray,     # (N, 3) estimated keyframe positions (world)
    min_gap: int = 20,         # temporal separation in keyframes
    radius: float = 5.0,       # spatial proximity gate (m) at zero travel
    min_spacing: int = 5,      # keyframes between accepted loop queries
    min_travel: float = 0.0,   # traveled path (m) required between j and k
    drift_rate: float = 0.0,   # radius growth per metre of path between j, k
) -> list[tuple[int, int]]:
    """Proximity-gated revisit candidates: (j, k) with j + min_gap <= k, at
    least ``min_travel`` metres of traveled path between them, and
    |p_k - p_j| < radius + drift_rate * path(j..k); per k the closest such j
    (by distance normalised to its gate); at most one candidate every
    ``min_spacing`` keyframes."""
    pos = np.asarray(positions, np.float64)
    cum = path_cumlen(pos)
    n = len(pos)
    pairs: list[tuple[int, int]] = []
    last_k = -(10**9)
    for k in range(n):
        j_hi = k - min_gap
        if j_hi <= 0 or k - last_k < min_spacing:
            continue
        d = np.linalg.norm(pos[:j_hi] - pos[k], axis=1)
        eff = radius + drift_rate * (cum[k] - cum[:j_hi])
        ok = (cum[k] - cum[:j_hi] >= min_travel) & (d < eff)
        if not np.any(ok):
            continue
        score = np.where(ok, d / eff, np.inf)
        j = int(np.argmin(score))
        pairs.append((j, k))
        last_k = k
    return pairs


def _clouds(f: ScanFeatures):
    """(points (N, 3), mask (N,)) of a keyframe's less-flat and less-sharp
    clouds together."""
    pts = torch.cat([f.less_flat[:, :3], f.less_sharp[:, :3]])
    msk = torch.cat([f.less_flat_mask, f.less_sharp_mask])
    return pts, msk


def occupancy(p, m, cell: float, half: float):
    """Coarse 2D occupancy counts of the points p (..., N, 3) under mask m
    (..., N), one (G, G) grid of side G = 2 half / cell per leading index,
    clipped at 4 (density must not dominate).  The counts are integers, so
    the scatter's float atomics sum them exactly whatever their order."""
    G = int(2 * half / cell)
    ix = torch.clamp(div_exact(p[..., 0] + half, cell).to(torch.int64), 0, G - 1)
    iy = torch.clamp(div_exact(p[..., 1] + half, cell).to(torch.int64), 0, G - 1)
    lead = p.shape[:-2]
    base = torch.arange(math.prod(lead), device=p.device).reshape(lead + (1,)) * (G * G)
    g = torch.zeros(math.prod(lead) * G * G, dtype=torch.float32, device=p.device)
    g.index_put_(((base + ix * G + iy).reshape(-1),),
                 torch.where(m, 1.0, 0.0).expand(ix.shape).reshape(-1), accumulate=True)
    return torch.clamp(g.reshape(lead + (G, G)), max=4.0)


def coarse_scores(feats_j: ScanFeatures, feats_k: ScanFeatures, n_yaw: int = 128,
                  cell: float = 4.0, half: float = 96.0, search: int = 16):
    """The SE(2) correlation of ``coarse_align``: (scores (n_yaw, w, w) with
    w = 2 search + 1, yaws (n_yaw,), z offset ()).  scores[y, u, v] counts
    the overlap of k's structure occupancy rotated by yaws[y] with j's,
    shifted by ((u - search) cell, (v - search) cell).

    The 128 correlations are one ``F.conv2d`` of j's padded grid
    (1, 1, G + 2s, G + 2s) with the rotated grids of k as its filters
    (n_yaw, 1, G, G): a cross-correlation, like the reference's
    ``conv_general_dilated``.  The grids hold integers 0..4, so every product
    and partial sum (< 2^24) is exact in float32 and in TF32 alike; cuDNN is
    turned off for the call because its FFT and Winograd algorithms would
    round them."""
    def cloud(f):
        pts, msk = _clouds(f)
        r = torch.linalg.vector_norm(pts[:, :2], dim=1)
        # structure only: ground points correlate equally at any in-plane shift
        return pts, msk & (r > 3.0) & (r < half) & (pts[:, 2] > -1.0)

    pj, mj = cloud(feats_j)
    pk, mk = cloud(feats_k)
    gj = occupancy(pj, mj, cell, half)
    pad = F.pad(gj, (search, search, search, search))[None, None]
    yaws = 2 * math.pi * torch.arange(n_yaw, dtype=torch.float32, device=pj.device) / n_yaw
    cy, sy = torch.cos(yaws)[:, None], torch.sin(yaws)[:, None]
    rot = torch.stack([cy * pk[None, :, 0] - sy * pk[None, :, 1],
                       sy * pk[None, :, 0] + cy * pk[None, :, 1],
                       pk[None, :, 2].expand(n_yaw, -1)], dim=-1)        # (n_yaw, N, 3)
    gk = occupancy(rot, mk[None, :], cell, half)                         # (n_yaw, G, G)
    with torch.backends.cudnn.flags(enabled=False):
        # scores[y, u, v] = sum_ab gk[y, a, b] * gj[a + u - search, b + v - search]
        scores = F.conv2d(pad, gk[:, None])[0]
    wz_j = torch.sum(torch.where(mj, pj[:, 2], 0.0)) / torch.clamp(mj.sum(), min=1)
    wz_k = torch.sum(torch.where(mk, pk[:, 2], 0.0)) / torch.clamp(mk.sum(), min=1)
    return scores, yaws, wz_j - wz_k


def coarse_align(
    feats_j: ScanFeatures,
    feats_k: ScanFeatures,
    n_yaw: int = 128,          # yaw search bins (2.8 deg resolution)
    cell: float = 4.0,         # occupancy cell size (m)
    half: float = 96.0,        # grid half-extent (m)
    search: int = 16,          # translation search radius in cells (+-64 m)
    top_k: int = 1,
) -> torch.Tensor:
    """Scan-context-style SE(2) coarse alignment: (7,) pose j_T_k, or
    (top_k, 7) candidate poses when ``top_k > 1``.

    A joint dense search over SE(2) (``coarse_scores``): for every yaw bin,
    rotate k's structure points (off the ground, 3 m to ``half`` from the
    sensor), rasterise both clouds into clipped occupancy grids,
    cross-correlate over +-``search`` cells, and take the best cells.  The z
    offset comes from the masked mean heights.  ``top_k > 1`` picks peaks
    with suppression (+-4 yaw bins circularly, +-2 cells): in self-similar
    worlds the global peak aliases, so the caller refines several basins
    and arbitrates.  Scores are integers and ties are real:
    ``torch.argmax`` takes the first maximal index, as ``jnp.argmax``
    does."""
    scores, yaws, dz = coarse_scores(feats_j, feats_k, n_yaw, cell, half, search)
    dev = scores.device
    w = 2 * search + 1

    def pose_of(flat_idx):
        dyaw = yaws[flat_idx // (w * w)]
        uv = flat_idx % (w * w)
        dx = ((uv // w).to(torch.float32) - search) * cell
        dy = ((uv % w).to(torch.float32) - search) * cell
        quat = geo.angle_axis_to_quat(torch.stack([0.0 * dyaw, 0.0 * dyaw, dyaw]))
        return geo.pose_from_qt(quat, torch.stack([dx, dy, dz]))

    flat = scores.reshape(-1)
    if top_k == 1:
        return pose_of(torch.argmax(flat))
    n_cells = w * w
    ys = torch.arange(n_yaw, device=dev)
    us = torch.arange(w, device=dev)
    idxs = []
    for _ in range(top_k):
        best = torch.argmax(flat)
        idxs.append(best)
        by, buv = best // n_cells, best % n_cells
        bu, bv = buv // w, buv % w
        dy_c = torch.abs(ys - by)
        sup = ((torch.minimum(dy_c, n_yaw - dy_c) <= 4)[:, None, None]
               & (torch.abs(us - bu) <= 2)[None, :, None]
               & (torch.abs(us - bv) <= 2)[None, None, :])
        flat = torch.where(sup.reshape(-1), -torch.inf, flat)
    return torch.stack([pose_of(i) for i in idxs])


def tight_inlier_frac(
    feats_j: ScanFeatures,
    feats_k: ScanFeatures,
    pose: torch.Tensor,        # (7,) or (S, 7) candidate j_T_k
    thresh: float = 0.5,
    sample: int = 2048,
) -> torch.Tensor:
    """Fraction of (subsampled) k-points whose nearest j-point after
    transforming by ``pose`` lies within ``thresh`` metres: () or (S,).

    The registration arbiter: the LOAM association gate (5 m) scores aliased
    alignments in self-similar worlds almost as high as the true one, a
    0.5 m gate does not.  Structure only (z above the ground).  One
    nearest-neighbour search (``ops/knn.nn1``) takes every pose's strided
    sample at once."""
    def structure(f):
        pts, msk = _clouds(f)
        return pts, msk & (pts[:, 2] > -1.0)

    pk, mk = structure(feats_k)
    pj, mj = structure(feats_j)
    stride = max(pk.shape[0] // sample, 1)
    sub, qm = pk[::stride], mk[::stride]
    q = geo.pose_apply(pose[..., None, :], sub)                  # (..., Q, 3)
    d2, _ = nn1(q.reshape(-1, 3), pj, mj)
    nn = d2.reshape(q.shape[:-1])
    hits = torch.sum(qm & (nn < thresh * thresh), dim=-1)
    return hits / torch.clamp(qm.sum(), min=1)


def register_loop(
    feats_j: ScanFeatures,
    feats_k: ScanFeatures,
    rel_init: torch.Tensor,    # (7,) current estimate of j_T_k (from the chains)
    cfg: VloamConfig,
    outer_iters: int = 5,
    use_coarse: bool = True,
    coarse_top_k: int = 6,
    min_inlier_frac: float = 0.3,
) -> tuple[np.ndarray, int, bool]:
    """Scan-to-scan registration of keyframe k against keyframe j.

    Returns (z_jk (7,) j_T_k, tight-inlier count, accepted).  Seeds: the
    chain estimate plus the best ``coarse_top_k`` SE(2) correlation peaks;
    every seed is refined (``outer_iters`` association rounds, no
    distortion) and the best tight-inlier fraction wins.  Accepted when that
    fraction is at least ``min_inlier_frac`` and the pose is finite; the
    count is the fraction times 2048 (the driver's evidence weighting)."""
    loop_cfg = dataclasses.replace(
        cfg, odom=dataclasses.replace(cfg.odom, outer_iters=outer_iters, distortion=False))
    seeds = [rel_init.to(torch.float32)[None]]
    if use_coarse:
        seeds.append(coarse_align(feats_j, feats_k, top_k=coarse_top_k).reshape(-1, 7))
    poses, fracs = _refine_and_score_batch(feats_j, feats_k, torch.cat(seeds), loop_cfg)
    fracs = fracs.cpu().numpy()
    best = int(np.argmax(fracs))
    z = poses[best].cpu().numpy()
    best_frac = float(fracs[best])
    n_tight = int(best_frac * 2048)
    accepted = best_frac >= min_inlier_frac and bool(np.all(np.isfinite(z)))
    return z, n_tight, accepted


def _refine_and_score_batch(feats_j, feats_k, seeds, cfg):
    """Every seed refined and scored at once: (poses (S, 7), fractions (S,))."""
    poses, _ = solve_f2f_batched(
        feats_k, feats_j.less_sharp, feats_j.less_sharp_mask,
        feats_j.less_flat, feats_j.less_flat_mask, seeds, cfg,
    )
    return poses, tight_inlier_frac(feats_j, feats_k, poses)


def loop_factors(
    pairs: list[tuple[int, int]],
    zs: list[np.ndarray],
    weight: float | list[float] | np.ndarray = 5.0,
    device="cpu",
) -> PoseGraphFactors:
    """Accepted loop registrations -> relative-pose factors (i_T_j = z) on
    ``device``.  ``weight`` may be per factor (the driver's evidence
    weighting)."""
    if not pairs:
        return PoseGraphFactors(
            i=torch.zeros((0,), dtype=torch.int64, device=device),
            j=torch.zeros((0,), dtype=torch.int64, device=device),
            z=torch.zeros((0, 7), dtype=torch.float32, device=device),
            weight=torch.zeros((0,), dtype=torch.float32, device=device),
            valid=torch.zeros((0,), dtype=torch.bool, device=device),
        )
    w = np.broadcast_to(np.asarray(weight, np.float32), (len(pairs),))
    return PoseGraphFactors(
        i=torch.tensor([p[0] for p in pairs], dtype=torch.int64, device=device),
        j=torch.tensor([p[1] for p in pairs], dtype=torch.int64, device=device),
        z=torch.tensor(np.stack(zs), dtype=torch.float32, device=device),
        weight=torch.tensor(w.copy(), device=device),
        valid=torch.ones((len(pairs),), dtype=torch.bool, device=device),
    )
