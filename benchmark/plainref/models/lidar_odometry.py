"""Scan-to-scan lidar odometry (LO) — port of
``vloam_tpu/models/lidar_odometry.py``.

Per frame: two outer iterations, each one fused k-NN launch for both
association problems (sharp vs last less-sharp, flat vs last less-flat),
the ring-constrained picks from the k-NN lists, and one fused GN launch.
``solve_f2f_batched`` registers one scan from several seeds at once (loop
closure): still one k-NN launch and one GN launch an outer iteration.

With ``OdometryConfig.distortion`` each feature point carries its sweep
fraction s (the w channel is ring + 0.1 * rel_time): the queries and the
residuals go through the pose interpolated to s, solved by the generic GN
(``ops/gauss_newton.solve_pose_gn``, as the reference does: the fused
kernel assumes s = 1), and the clouds stored for the next frame are moved
to the sweep end (``lidar_factors.transform_to_end``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from plainref import geometry as geo
from plainref.config import VloamConfig
from plainref.ops import lidar_factors
from plainref.ops.fused_gn import solve_pose_gn_lidar, solve_pose_gn_lidar_batched
from plainref.ops.fused_knn import knn_pair
from plainref.ops.gauss_newton import solve_pose_gn
from plainref.ops.knn import masked_argmin
from plainref.ops.scan_registration import ScanFeatures
from plainref.ops.voxel import div_exact


class LoState(NamedTuple):
    last_corner: torch.Tensor        # (N_c, 4) xyzw — prev frame's less-sharp cloud
    last_corner_mask: torch.Tensor   # (N_c,)
    last_surf: torch.Tensor          # (N_s, 4) — prev frame's less-flat cloud
    last_surf_mask: torch.Tensor
    pose_wodom: torch.Tensor         # (7,) accumulated odometry-world pose
    last_delta: torch.Tensor         # (7,) previous frame-to-frame solution (warm start)
    initialized: bool                # host flag: the first frame only stores its clouds


def init_lo_state(cfg: VloamConfig, device) -> LoState:
    sc = cfg.scan
    n_c = sc.n_scans * sc.n_sectors * sc.max_less_sharp
    n_s = sc.less_flat_cap
    return LoState(
        last_corner=torch.zeros((n_c, 4), device=device),
        last_corner_mask=torch.zeros((n_c,), dtype=torch.bool, device=device),
        last_surf=torch.zeros((n_s, 4), device=device),
        last_surf_mask=torch.zeros((n_s,), dtype=torch.bool, device=device),
        pose_wodom=geo.pose_identity(device),
        last_delta=geo.pose_identity(device),
        initialized=False,
    )


def lo_state_from_numpy(state, device) -> LoState:
    """A reference ``LoState`` whose leaves are NumPy arrays -> this port's
    state on ``device``."""
    f = lambda x: torch.tensor(np.asarray(x), device=device)  # noqa: E731
    return LoState(
        last_corner=f(state.last_corner), last_corner_mask=f(state.last_corner_mask),
        last_surf=f(state.last_surf), last_surf_mask=f(state.last_surf_mask),
        pose_wodom=f(state.pose_wodom), last_delta=f(state.last_delta),
        initialized=bool(np.asarray(state.initialized)),
    )


def _ring_picks(d2, idx, cand, cfg):
    """From a k-NN list (..., M, k): the global nearest j, the nearest
    same-ring-as-j candidate != j, and the nearest nearby-other-ring candidate.

    Returns (d2_1, j1, d2_same, j_same, d2_other, j_other), each (..., M)."""
    oc = cfg.odom
    ring_c = torch.floor(cand[:, 3]).to(torch.int64)
    ring_n = ring_c[idx]                                     # (..., M, k)
    ring1 = ring_n[..., :1]

    d2_1, j1 = d2[..., 0], idx[..., 0]
    same = ring_n == ring1
    same[..., 0] = False
    dring = torch.abs(ring_n - ring1).to(torch.float32)
    other = (ring_n != ring1) & (dring <= oc.nearby_scan)

    d2_s, c_s = masked_argmin(d2, same)
    d2_o, c_o = masked_argmin(d2, other)
    j_s = torch.gather(idx, -1, c_s[..., None])[..., 0]
    j_o = torch.gather(idx, -1, c_o[..., None])[..., 0]
    return d2_1, j1, d2_s, j_s, d2_o, j_o


def _edge_correspondences(d2, idx, sharp, sharp_mask, cand, cfg):
    """Point-to-line data: closest candidate + nearest candidate on a
    different but nearby ring."""
    thr = cfg.odom.distance_sq_threshold
    d2_1, j1, _, _, d2_2, j2 = _ring_picks(d2, idx, cand, cfg)
    valid = sharp_mask & (d2_1 < thr) & (d2_2 < thr)
    return sharp[:, :3], cand[j1, :3], cand[j2, :3], valid


def _plane_correspondences(d2, idx, flat, flat_mask, cand, cfg):
    """Point-to-plane data: closest j, nearest same-ring l != j, nearest
    nearby-other-ring m."""
    thr = cfg.odom.distance_sq_threshold
    d2_1, j1, d2_2, j2, d2_3, j3 = _ring_picks(d2, idx, cand, cfg)
    valid = flat_mask & (d2_1 < thr) & (d2_2 < thr) & (d2_3 < thr)
    pj, pl, pm = cand[j1, :3], cand[j2, :3], cand[j3, :3]
    nrm, d = lidar_factors.plane_from_three_points(pj, pl, pm)
    # degenerate normals (colinear triples) are rejected
    ok_n = torch.linalg.vector_norm(torch.linalg.cross(pj - pl, pj - pm, dim=-1), dim=-1) > 1e-10
    return flat[:, :3], nrm, d, valid & ok_n


def solve_f2f(feats: ScanFeatures, cand_corner, cand_corner_mask, cand_surf,
              cand_surf_mask, pose0, cfg: VloamConfig):
    """Register ``feats`` against the candidate clouds.  Returns
    (pose cand_T_feats, counts (2,) edge/plane correspondences)."""
    oc = cfg.odom
    surf_n = _surf_count(cand_surf_mask)
    if oc.distortion:
        s_e = sweep_fraction(feats.sharp, cfg)
        s_s = sweep_fraction(feats.flat, cfg)

    pose = pose0
    for _ in range(oc.outer_iters):
        if oc.distortion:
            # TransformToStart with the per-point slerp fraction
            q_e = lidar_factors.pose_apply_interp(pose, feats.sharp[:, :3], s_e)
            q_s = lidar_factors.pose_apply_interp(pose, feats.flat[:, :3], s_s)
        else:
            q_e = geo.pose_apply(pose, feats.sharp[:, :3])
            q_s = geo.pose_apply(pose, feats.flat[:, :3])
        (d2e, idxe), (d2s, idxs) = knn_pair(
            q_e, cand_corner[:, :3], cand_corner_mask, oc.assoc_k,
            q_s, cand_surf[:, :3], cand_surf_mask, oc.assoc_k_surf,
            b_counts=(None, surf_n),
        )
        p_e, a_e, b_e, v_e = _edge_correspondences(
            d2e, idxe, feats.sharp, feats.sharp_mask, cand_corner, cfg)
        p_s, n_s, d_s, v_s = _plane_correspondences(
            d2s, idxs, feats.flat, feats.flat_mask, cand_surf, cfg)
        if oc.distortion:
            def residuals(pp, p_e=p_e, a_e=a_e, b_e=b_e, v_e=v_e,
                          p_s=p_s, n_s=n_s, d_s=d_s, v_s=v_s):
                return ((lidar_factors.edge_residual_interp(pp, p_e, a_e, b_e, s_e), v_e),
                        (lidar_factors.plane_residual_interp(pp, p_s, n_s, d_s, s_s), v_s))

            pose = solve_pose_gn(residuals, pose, oc.inner_iters, oc.huber_delta, oc.lm_lambda)
        else:
            pose = solve_pose_gn_lidar(
                pose, (p_e, a_e, b_e, v_e), (p_s, n_s, d_s, v_s),
                oc.inner_iters, oc.huber_delta, oc.lm_lambda,
            )
    counts = torch.stack([v_e.sum(), v_s.sum()]).to(torch.int32)
    return pose, counts


def sweep_fraction(pts, cfg: VloamConfig):
    """Per-point intra-sweep time fraction s = clip(frac(w) / scan_period,
    0, 1) of a feature cloud's w channel (ring + 0.1 * rel_time)."""
    w = pts[:, 3]
    return torch.clamp(div_exact(w - torch.floor(w), cfg.scan.scan_period), 0.0, 1.0)


def _surf_count(cand_surf_mask):
    """Valid-prefix length of the less-flat buffer: it may carry masked
    holes, so the kernel honours this count AND the mask."""
    n_sc = cand_surf_mask.shape[0]
    return torch.amax(torch.where(
        cand_surf_mask, torch.arange(1, n_sc + 1, device=cand_surf_mask.device), 0))


def solve_f2f_batched(feats: ScanFeatures, cand_corner, cand_corner_mask, cand_surf,
                      cand_surf_mask, poses0, cfg: VloamConfig):
    """``solve_f2f`` from S seeds ``poses0`` (S, 7) at once (the reference's
    ``jax.vmap(solve_f2f)`` over loop closure's seeds).  Per outer iteration
    one ``knn_pair`` launch for all seeds, their transformed queries stacked
    into (S * M, 3) against the one pair of candidate clouds (a query's row
    is what an unbatched call gives it: the search rebases on the candidates
    alone), and one batched GN launch.  Returns (poses (S, 7), counts (S, 2))."""
    oc = cfg.odom
    if oc.distortion:
        raise NotImplementedError(
            "solve_f2f_batched solves at s = 1 only (the fused GN kernel): its one caller, "
            "loop closure's register_loop, turns OdometryConfig.distortion off")
    S, me, ms = poses0.shape[0], feats.sharp.shape[0], feats.flat.shape[0]
    surf_n = _surf_count(cand_surf_mask)
    pose = poses0
    for _ in range(oc.outer_iters):
        q_e = geo.pose_apply(pose[:, None, :], feats.sharp[None, :, :3])
        q_s = geo.pose_apply(pose[:, None, :], feats.flat[None, :, :3])
        (d2e, idxe), (d2s, idxs) = knn_pair(
            q_e.reshape(S * me, 3), cand_corner[:, :3], cand_corner_mask, oc.assoc_k,
            q_s.reshape(S * ms, 3), cand_surf[:, :3], cand_surf_mask, oc.assoc_k_surf,
            b_counts=(None, surf_n),
        )
        p_e, a_e, b_e, v_e = _edge_correspondences(
            d2e.view(S, me, -1), idxe.view(S, me, -1), feats.sharp, feats.sharp_mask,
            cand_corner, cfg)
        p_s, n_s, d_s, v_s = _plane_correspondences(
            d2s.view(S, ms, -1), idxs.view(S, ms, -1), feats.flat, feats.flat_mask,
            cand_surf, cfg)
        # the feature points are the same for every seed: batch stride 0
        pose = solve_pose_gn_lidar_batched(
            pose, (p_e.expand(S, -1, -1), a_e, b_e, v_e), (p_s.expand(S, -1, -1), n_s, d_s, v_s),
            oc.inner_iters, oc.huber_delta, oc.lm_lambda,
        )
    counts = torch.stack([v_e.sum(-1), v_s.sum(-1)], dim=-1).to(torch.int32)
    return pose, counts


def lo_step(state: LoState, feats: ScanFeatures, cfg: VloamConfig, vo_prior=None):
    """One LO frame.  Returns (new_state, f2f pose last_T_curr, world pose,
    corr_counts (2,)).  ``vo_prior`` (a 7-pose, velodyne frame, last_T_curr)
    seeds the solve in the coupled mode (laser_odometry.cpp:237-250);
    otherwise the previous solution warm-starts it."""
    dev = state.pose_wodom.device
    pose0 = state.last_delta if vo_prior is None else vo_prior
    if state.initialized:
        delta, corr_counts = solve_f2f(
            feats, state.last_corner, state.last_corner_mask,
            state.last_surf, state.last_surf_mask, pose0, cfg,
        )
        pose_w = geo.pose_compose(state.pose_wodom, delta)
        last_delta = delta
    else:
        delta = geo.pose_identity(dev)
        corr_counts = torch.zeros((2,), dtype=torch.int32, device=dev)
        pose_w = state.pose_wodom
        last_delta = state.last_delta

    store_corner, store_surf = feats.less_sharp, feats.less_flat
    if cfg.odom.distortion:
        # the next frame's targets, rigid in their sweep-end anchor; the w
        # channel keeps ring + time
        store_corner, store_surf = (
            torch.cat([lidar_factors.transform_to_end(delta, c[:, :3], sweep_fraction(c, cfg)),
                       c[:, 3:]], dim=1)
            for c in (store_corner, store_surf))
    new_state = LoState(
        last_corner=store_corner,
        last_corner_mask=feats.less_sharp_mask,
        last_surf=store_surf,
        last_surf_mask=feats.less_flat_mask,
        pose_wodom=pose_w,
        last_delta=last_delta,
        initialized=True,
    )
    return new_state, delta, pose_w, corr_counts
