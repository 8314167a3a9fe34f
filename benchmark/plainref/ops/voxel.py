"""Voxel-grid downsampling (port of ``vloam_tpu/ops/voxel.voxel_downsample``).

Points are quantised to integer voxel coordinates relative to the masked
minimum and packed into one key; rows with the same key (and the same group
key) form one segment and are replaced by their centroid (all channels
averaged, PCL VoxelGrid semantics).  Two ways to form the segments:

* ``presorted=True`` (this port's default: the scan-ordered feature clouds)
  merges consecutive runs in the given order, so a voxel revisited later in
  the sweep keeps a second centroid, as in the reference;
* ``presorted=False`` (the reference's default; the map re-voxelisation of
  ``insert_dedup=False``) sorts stably by key first (with a group key, two
  stable passes: key, then group) and emits the centroids in sorted-key
  order, truncated at ``cap``.

``voxel_downsample_batched`` runs B independent clouds at once, each
quantised from its own masked minimum (the reference's ``jax.vmap``).
"""

from __future__ import annotations

import torch

INT_MAX = 2**31 - 1


def div_exact(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as a true float32 division.  (CUDA turns division by a host
    scalar into multiplication by its reciprocal, which moves floor()
    boundaries by an ulp; dividing by a device tensor does not.)"""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def voxel_downsample(
    points: torch.Tensor,     # (N, D); the first 3 channels are xyz
    mask: torch.Tensor,       # (N,) bool
    leaf: float,
    cap: int,
    group_key: torch.Tensor | None = None,  # (N,) int: points in different groups never merge
    max_grid: int = 1024,
    presorted: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out_points (cap, D), out_mask (cap,)); the valid rows form a
    prefix.  Surplus segments past ``cap`` are dropped."""
    out, out_mask = voxel_downsample_batched(
        points[None], mask[None], leaf, cap, None if group_key is None else group_key[None],
        max_grid, presorted)
    return out[0], out_mask[0]


def voxel_downsample_batched(points, mask, leaf: float, cap: int, group_key=None,
                             max_grid: int = 1024, presorted: bool = True):
    """``voxel_downsample`` over B clouds: points (B, N, D), mask (B, N),
    group_key (B, N) or None.  Returns ((B, cap, D), (B, cap))."""
    B, n, D = points.shape
    dev = points.device
    xyz = points[..., :3]
    p_min = torch.where(mask[..., None], xyz, 1e30).amin(dim=1, keepdim=True)
    ijk = torch.floor(div_exact(xyz - p_min, leaf)).to(torch.int64)
    ijk = torch.clamp(ijk, 0, max_grid - 1)
    key = ijk[..., 0] + max_grid * ijk[..., 1] + max_grid * max_grid * ijk[..., 2]
    key = torch.where(mask, key, INT_MAX)

    if presorted:
        key_s, grp_s, pts_s, msk_s = key, group_key, points, mask
    else:
        key_s, order = torch.sort(key, dim=1, stable=True)
        grp_s = None
        if group_key is not None:
            group_key = torch.where(mask, group_key, INT_MAX)
            grp_s, by_group = torch.sort(torch.gather(group_key, 1, order), dim=1, stable=True)
            order = torch.gather(order, 1, by_group)
            key_s = torch.gather(key, 1, order)
        pts_s = torch.gather(points, 1, order[..., None].expand(-1, -1, D))
        msk_s = torch.gather(mask, 1, order)

    new_seg = torch.ones((B, n), dtype=torch.bool, device=dev)
    new_seg[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
    if grp_s is not None:
        new_seg[:, 1:] |= grp_s[:, 1:] != grp_s[:, :-1]
    new_seg = new_seg & msk_s
    # Invalid rows keep the running segment id (their contribution is zeroed
    # below); a leading invalid prefix clamps to 0.
    seg_id = torch.clamp(torch.cumsum(new_seg.to(torch.int64), 1) - 1, min=0)
    seg_id = seg_id + n * torch.arange(B, device=dev)[:, None]

    aug = torch.cat([pts_s, torch.ones_like(pts_s[..., :1])], dim=-1)
    aug = torch.where(msk_s[..., None], aug, 0.0)
    # float atomics on CUDA: the summation order varies from run to run
    sums5 = torch.zeros((B * n, D + 1), dtype=points.dtype, device=dev).index_add_(
        0, seg_id.reshape(-1), aug.reshape(-1, D + 1)).view(B, n, D + 1)
    sums, cnts = sums5[..., :-1], sums5[..., -1]
    total = new_seg.sum(dim=1)

    means = sums / torch.clamp(cnts, min=1.0)[..., None]
    if cap > n:
        means = torch.cat([means, means.new_zeros((B, cap - n, D))], dim=1)
    out = means[:, :cap]
    out_mask = torch.arange(cap, device=dev) < torch.clamp(total, max=cap)[:, None]
    return torch.where(out_mask[..., None], out, 0.0), out_mask
