"""CLAHE, contrast-limited adaptive histogram equalisation (port of
``vloam_tpu/ops/clahe.py``; ``cv::createCLAHE(2.0)``, visual_odometry.cpp:
32-33,110-114).

OpenCV semantics: split the image into tiles, build a 256-bin histogram per
tile, clip it at ``clip_limit * pixels_per_tile / 256`` and spread the excess
evenly over the bins, turn each tile's CDF into a lookup table, and map
every pixel through the bilinear blend of its four surrounding tiles' LUTs.

The reference builds the histograms as a (tiles, pixels, 256) float one-hot
and the blend from four (H, W, 256) LUT stacks (~480 MB each at 376x1248).
Here the histograms are integer counts added per (tile, bin), exact in any
order, and each corner's LUT value is one gather ``luts[y, x, q]``.
"""

from __future__ import annotations

import torch

from plainref.ops.voxel import div_exact


def clahe(img: torch.Tensor, clip_limit: float = 2.0, tiles: tuple[int, int] = (8, 8)) -> torch.Tensor:
    """(H, W) float32 in [0, 255] -> the equalised image, same shape."""
    H, W = img.shape
    ty, tx = tiles
    th, tw = H // ty, W // tx
    if th * ty != H or tw * tx != W:
        raise ValueError(f"image {H}x{W} does not divide into {ty}x{tx} tiles")
    dev = img.device

    q = torch.clamp(img, 0.0, 255.0).to(torch.int64)              # (H, W) bins
    tile = ((torch.arange(H, device=dev) // th)[:, None] * tx
            + (torch.arange(W, device=dev) // tw)[None, :])
    counts = torch.zeros(ty * tx * 256, dtype=torch.int32, device=dev).index_add_(
        0, (tile * 256 + q).reshape(-1), torch.ones(H * W, dtype=torch.int32, device=dev))
    hist = counts.view(ty * tx, 256).to(torch.float32)

    # clip + one uniform redistribution pass (as OpenCV)
    npix = float(th * tw)
    limit = max(clip_limit * npix / 256.0, 1.0)
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / 256.0

    cdf = torch.cumsum(hist, dim=1)
    luts = (cdf - cdf[:, :1]) / torch.clamp(npix - cdf[:, :1], min=1.0) * 255.0
    luts = torch.clamp(luts, 0.0, 255.0).view(ty, tx, 256)

    # bilinear blend of the 4 surrounding tile LUTs per pixel (tile-space coords)
    yy = div_exact(torch.arange(H, dtype=torch.float32, device=dev) + 0.5, th) - 0.5
    xx = div_exact(torch.arange(W, dtype=torch.float32, device=dev) + 0.5, tw) - 0.5
    y0 = torch.clamp(torch.floor(yy).to(torch.int64), 0, ty - 1)
    x0 = torch.clamp(torch.floor(xx).to(torch.int64), 0, tx - 1)
    y1 = torch.clamp(y0 + 1, 0, ty - 1)
    x1 = torch.clamp(x0 + 1, 0, tx - 1)
    fy = torch.clamp(yy - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(xx - x0, 0.0, 1.0)[None, :]

    def lut_at(ys, xs):
        return luts[ys[:, None], xs[None, :], q]                  # (H, W)

    return (lut_at(y0, x0) * (1 - fy) * (1 - fx)
            + lut_at(y0, x1) * (1 - fy) * fx
            + lut_at(y1, x0) * fy * (1 - fx)
            + lut_at(y1, x1) * fy * fx)
