"""Voxel-grid downsampling, run-merge path (port of
``vloam_tpu/ops/voxel.voxel_downsample`` with ``presorted=True``).

Points are quantised to integer voxel coordinates relative to the masked
minimum and packed into one key; consecutive rows with the same key (and the
same group key) form one run and are replaced by their centroid (all
channels averaged, PCL VoxelGrid semantics for scan-ordered clouds).  A
voxel revisited later in the sweep keeps a second centroid, as in the
reference.  The reference's sorting path (``presorted=False``) is not
ported: its one caller there is the window re-voxelisation of
``insert_dedup=False`` (ROADMAP A5), and it comes with that.
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out_points (cap, D), out_mask (cap,)); the valid rows form a
    prefix.  Surplus runs past ``cap`` are dropped."""
    n, D = points.shape
    dev = points.device
    xyz = points[:, :3]
    p_min = torch.where(mask[:, None], xyz, 1e30).amin(dim=0)
    ijk = torch.floor(div_exact(xyz - p_min, leaf)).to(torch.int64)
    ijk = torch.clamp(ijk, 0, max_grid - 1)
    key = ijk[:, 0] + max_grid * ijk[:, 1] + max_grid * max_grid * ijk[:, 2]
    key = torch.where(mask, key, INT_MAX)

    new_seg = torch.ones((n,), dtype=torch.bool, device=dev)
    new_seg[1:] = key[1:] != key[:-1]
    if group_key is not None:
        new_seg[1:] |= group_key[1:] != group_key[:-1]
    new_seg = new_seg & mask
    # Invalid rows keep the running segment id (their contribution is zeroed
    # below); a leading invalid prefix clamps to 0.
    seg_id = torch.clamp(torch.cumsum(new_seg.to(torch.int64), 0) - 1, min=0)

    aug = torch.cat([points, torch.ones_like(points[:, :1])], dim=1)
    aug = torch.where(mask[:, None], aug, 0.0)
    # float atomics on CUDA: the summation order varies from run to run
    sums5 = torch.zeros((n, D + 1), dtype=points.dtype, device=dev).index_add_(0, seg_id, aug)
    sums, cnts = sums5[:, :-1], sums5[:, -1]
    total = new_seg.sum()

    means = sums / torch.clamp(cnts, min=1.0)[:, None]
    if cap > n:
        means = torch.cat([means, means.new_zeros((cap - n, D))])
    out = means[:cap]
    out_mask = torch.arange(cap, device=dev) < torch.clamp(total, max=cap)
    return torch.where(out_mask[:, None], out, 0.0), out_mask
