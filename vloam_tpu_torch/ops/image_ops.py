"""2D feature frontend: corners and pyramidal Lucas-Kanade (port of
``vloam_tpu/ops/image_ops.py``).

  * Shi-Tomasi response: the min eigenvalue of the 5x5 box-filtered
    structure tensor, from separable shift-and-add convolutions (the tap
    order of the reference is kept, so CPU sums round as there).
  * FAST-9/16 response (``detector_type="fast"``): the summed threshold
    excess over the radius-3 circle where 9 contiguous circle pixels are all
    brighter or all darker, from 16 wrapping rolls of the image.
  * Corner selection: 7x7 local-max suppression, quality gate against the
    image maximum (FAST: a positive response instead), a border margin,
    then the global top ``max_corners`` into a fixed buffer (ties to the
    lower pixel index, as ``lax.top_k``).
  * ``bucket_nms``: at most max_total / n_buckets keypoints a 100x100 px
    bucket, the strongest kept (keyPointsNMS, image_util.cpp:202-261).
  * Pyramidal LK with a forward-backward check: per feature and level one
    (P, P) patch is sliced from each image (``ops/patch_gather``, the CUDA
    kernel B2), and every window resample inside the GN loop is two batched
    interpolation products over the patch.  ``_sample_windows`` rounds its
    inputs to bf16 and accumulates in f32, as the reference does.

All images are (H, W) float32 in [0, 255]; keypoints are (N, 2) float32
``(x, y)`` pixel coordinates with a validity mask.  Control flow that was
``lax.cond``/``lax.scan`` is a Python branch on a host value or a Python
loop with an on-device freeze mask: nothing here reads the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vloam_tpu_torch.config import VisualConfig
from vloam_tpu_torch.ops.patch_gather import gather_patches_pair
from vloam_tpu_torch.ops.voxel import div_exact

NEG_BIG = float(np.float32(-3.4e38))


def _conv1d_shift(img: torch.Tensor, k, axis: int) -> torch.Tensor:
    """1D SAME (zero-padded) convolution along ``axis`` as a shift-and-add,
    the taps summed in order."""
    r = len(k) // 2
    padded = F.pad(img, (0, 0, r, r) if axis == 0 else (r, r, 0, 0))
    n = img.shape[axis]
    out = None
    for i, ki in enumerate(k):
        term = ki * padded.narrow(axis, i, n)
        out = term if out is None else out + term
    return out


def _sep_conv(img: torch.Tensor, kx, ky) -> torch.Tensor:
    """Separable 2D convolution (SAME padding): rows with ``ky``, then
    columns with ``kx``."""
    return _conv1d_shift(_conv1d_shift(img, list(ky), 0), list(kx), 1)


def sobel_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    smooth = [0.25, 0.5, 0.25]
    diff = [-0.5, 0.0, 0.5]
    return _sep_conv(img, diff, smooth), _sep_conv(img, smooth, diff)


def shi_tomasi_response(img: torch.Tensor, block_size: int = 5) -> torch.Tensor:
    """Min-eigenvalue corner response with a block_size box window."""
    ix, iy = sobel_gradients(img)
    box = [1.0 / block_size] * block_size
    sxx = _sep_conv(ix * ix, box, box)
    syy = _sep_conv(iy * iy, box, box)
    sxy = _sep_conv(ix * iy, box, box)
    tr = sxx + syy
    det_part = torch.sqrt(torch.clamp((sxx - syy) ** 2 + 4.0 * sxy * sxy, min=0.0))
    return 0.5 * (tr - det_part)


# radius-3 Bresenham circle offsets (dy, dx), OpenCV's order
FAST_CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
               (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


def fast_response(img: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """FAST-9/16 corner response (the reference's DetectorType::FAST,
    image_util.cpp:83-87): a pixel is a corner when >= 9 contiguous pixels
    of the radius-3 circle are all brighter than centre + t or all darker
    than centre - t; its response is the summed threshold excess over the
    circle, in circle order.  The circle wraps at the image edges, as the
    reference's ``jnp.roll`` does: a wrapped border response takes part in
    the local-max suppression of interior peaks."""
    circ = [torch.roll(img, (-dy, -dx), dims=(0, 1)) for dy, dx in FAST_CIRCLE]

    def arc9(flags):
        # any circular run of 9: AND of the 9 shifts along the circle axis
        run = flags
        for k in range(1, 9):
            run = run & torch.roll(flags, -k, dims=0)
        return run.any(dim=0)

    is_corner = (arc9(torch.stack([c > img + threshold for c in circ]))
                 | arc9(torch.stack([c < img - threshold for c in circ])))
    excess = sum(torch.clamp(torch.abs(c - img) - threshold, min=0.0) for c in circ)
    return torch.where(is_corner, excess, 0.0)


def border_mask(H: int, W: int, b: int, device) -> torch.Tensor:
    """(H, W) mask of the pixels at least ``b`` from every edge."""
    yy = torch.arange(H, device=device)[:, None]
    xx = torch.arange(W, device=device)[None, :]
    return (yy >= b) & (yy < H - b) & (xx >= b) & (xx < W - b)


def neighbour_max(x: torch.Tensor) -> torch.Tensor:
    """Maximum over the 8 neighbours in the last two dims (the centre pixel
    excluded), wrapping at the edges as the reference's rolls do."""
    mx = torch.full_like(x, -torch.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                mx = torch.maximum(mx, torch.roll(x, (dy, dx), (-2, -1)))
    return mx


def top_k(x: torch.Tensor, k: int):
    """The ``k`` largest entries of a 1-D ``x`` and their indices, exactly and
    in ``lax.top_k``'s order: descending, ties to the lower index (a stable
    sort; ``torch.topk`` promises no order among equal values).  This is the
    reference's ``approx_max_k`` on the CPU, where it is exact."""
    top, idx = torch.sort(x, descending=True, stable=True)
    return top[:k], idx[:k]


def detect_corners(img: torch.Tensor, cfg: VisualConfig):
    """Corners -> (pts (max_corners, 2) xy, mask, response).
    ``cfg.detector_type``: "shitomasi" (the reference's goodFeaturesToTrack)
    or "fast" (FAST-9/16, thresholded absolutely: no quality gate, peaks
    need a positive response)."""
    if cfg.detector_type == "shitomasi":
        resp = shi_tomasi_response(img, cfg.block_size)
    elif cfg.detector_type == "fast":
        resp = fast_response(img, cfg.fast_threshold)
    else:
        raise ValueError(f"unsupported detector_type={cfg.detector_type!r} (shitomasi|fast)")
    H, W = resp.shape

    # local-max suppression over a (2r+1)^2 window, r from minDistance (the
    # reference's separable shift-max with -inf padding is this max pool)
    r = max(int(cfg.min_distance // 2), 1)
    local_max = F.max_pool2d(resp[None, None], 2 * r + 1, stride=1, padding=r)[0, 0]
    if cfg.detector_type == "shitomasi":
        is_peak = (resp >= local_max) & (resp >= cfg.quality_level * torch.amax(resp))
    else:
        is_peak = (resp >= local_max) & (resp > 0.0)

    # safety border (gradients and windows are invalid at the edges)
    is_peak = is_peak & border_mask(H, W, cfg.block_size, resp.device)

    top, idx = top_k(torch.where(is_peak, resp, NEG_BIG).reshape(-1), cfg.max_corners)
    pts = torch.stack([(idx % W).to(torch.float32), (idx // W).to(torch.float32)], dim=-1)
    return pts, top > NEG_BIG, top


def bucket_nms(pts, mask, resp, cfg: VisualConfig):
    """The reference's keyPointsNMS (image_util.cpp:202-261): keep the
    strongest max_total // n_buckets keypoints (at least 1) of each
    nms_bucket_width x nms_bucket_height bucket.  Returns the updated mask."""
    n = pts.shape[0]
    dev = pts.device
    bx = div_exact(pts[:, 0], cfg.nms_bucket_width).to(torch.int64)   # toward zero
    by = div_exact(pts[:, 1], cfg.nms_bucket_height).to(torch.int64)
    nbx = -(-cfg.img_width // cfg.nms_bucket_width)
    nby = -(-cfg.img_height // cfg.nms_bucket_height)
    cap = max(cfg.nms_max_total // (nbx * nby), 1)
    bucket = torch.where(mask, bx * nby + by, nbx * nby)
    # rank within a bucket by response: stable sorts by -resp, then bucket
    order = torch.sort(-torch.where(mask, resp, -torch.inf), stable=True).indices
    b_s, by_bucket = torch.sort(bucket[order], stable=True)
    order = order[by_bucket]
    idx = torch.arange(n, device=dev)
    is_start = torch.ones((n,), dtype=torch.bool, device=dev)
    is_start[1:] = b_s[1:] != b_s[:-1]
    rank = idx - torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    keep = torch.zeros_like(mask)
    keep[order] = rank < cap
    return mask & keep


def gaussian_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """[level0 (full res), ..., levelN] with 5-tap Gaussian + 2x decimation."""
    g = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]
    pyr = [img]
    for _ in range(levels):
        pyr.append(_sep_conv(pyr[-1], g, g)[::2, ::2].contiguous())
    return pyr


def _tent_weights(x: torch.Tensor, P: int) -> torch.Tensor:
    """Bilinear (tent) weights onto an integer grid of size P:
    x (..., w) patch-space coordinates -> (..., w, P), two non-zeros a row."""
    xc = torch.clamp(x, 0.0, P - 1.000001)
    grid = torch.arange(P, dtype=torch.float32, device=x.device)
    return torch.clamp(1.0 - torch.abs(xc[..., None] - grid), min=0.0)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def sample_taps(flat: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(N, M) values, (N, K * 4) indices of four taps a sample into them and
    (N, K, 4) bf16-rounded weights -> (N, K) samples: the sum of the four
    products of the bf16-rounded values and the weights, in f32.

    This is the reference's product with a dense bank of rows of four
    non-zero weights (bf16 operands, f32 accumulation: brisk.py:285-289,
    sift.py:271-275, akaze.py:272-276) without the bank: the other terms
    add exact zeros and a product of two bf16 values is exact in f32, so
    only the order of the four additions may differ from the reference's."""
    taps = _bf16(torch.gather(flat, 1, idx)).reshape(w.shape) * w
    return ((taps[..., 0] + taps[..., 1]) + taps[..., 2]) + taps[..., 3]


def _sample_windows(patch: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """(N,P,P) patches x (N,w,P) row/column weights -> (N,w,w) windows.

    As the reference: inputs rounded to bf16, products accumulated in f32
    (the product of two bf16 values is exact in f32, and TF32 is off)."""
    tmp = torch.bmm(_bf16(wy), _bf16(patch))
    return torch.bmm(_bf16(tmp), _bf16(wx).transpose(1, 2))


def _patch_sobel(patch: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Sobel taps of sobel_gradients on a (N, P, P) patch stack, with
    wrap-around at the patch edge (never sampled: the tracking window stays
    >= klt_patch_slack px inside the patch)."""
    def conv(x, k, axis):
        return k[0] * torch.roll(x, 1, axis) + k[1] * x + k[2] * torch.roll(x, -1, axis)

    smooth = (0.25, 0.5, 0.25)
    diff = (-0.5, 0.0, 0.5)
    gx = conv(conv(patch, diff, 2), smooth, 1)
    gy = conv(conv(patch, smooth, 2), diff, 1)
    return gx, gy


def _window_hessian(Ix: torch.Tensor, Iy: torch.Tensor, w: int, cfg: VisualConfig):
    """Inverse of the 2x2 structure tensor per feature + validity gate."""
    gxx = torch.sum(Ix * Ix, dim=(1, 2))
    gxy = torch.sum(Ix * Iy, dim=(1, 2))
    gyy = torch.sum(Iy * Iy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    min_eig = 0.5 * (gxx + gyy - torch.sqrt((gxx - gyy) ** 2 + 4 * gxy ** 2)) / (w * w)
    ok_g = (det > 1e-6) & (min_eig > cfg.klt_min_eig * 255.0 ** 2 * 0.0001)
    safe_det = torch.where(det > 1e-6, det, 1.0)
    return gyy / safe_det, -gxy / safe_det, gxx / safe_det, ok_g


def _gn_iterations(patch, T, Ix, Iy, inv00, inv01, inv11, xs0, ys0, flow, gate,
                   cfg: VisualConfig, P: int, n_iters: int | None = None):
    """The LK GN loop, unrolled: cv's EPS criterion becomes a per-feature
    freeze mask on the device (converged features take zero steps; there
    is no early exit, which would need a sync)."""
    active = torch.ones(flow.shape[:1], dtype=torch.bool, device=flow.device)
    for _ in range(cfg.klt_iters if n_iters is None else n_iters):
        Cw = _sample_windows(
            patch, _tent_weights(ys0 + flow[:, 1:2], P), _tent_weights(xs0 + flow[:, 0:1], P))
        diff = Cw - T
        bx = torch.sum(diff * Ix, dim=(1, 2))
        by = torch.sum(diff * Iy, dim=(1, 2))
        dx = -(inv00 * bx + inv01 * by)
        dy = -(inv01 * bx + inv11 * by)
        step = torch.where((gate & active)[:, None], torch.stack([dx, dy], dim=-1), 0.0)
        still = torch.amax(torch.abs(step), dim=-1) > cfg.klt_eps
        flow = flow + step
        active = active & still
    return flow


def _level_geometry(pimg, p_lvl, flow, cfg: VisualConfig):
    """Patch size, window offsets and the clipped int32 patch corners of one
    level: template patch at the feature, current patch at its predicted
    position (so prior-seeded flows far beyond the slack stay inside)."""
    r = cfg.klt_window // 2
    ph = r + cfg.klt_patch_slack + 1
    P = 2 * ph
    offs1d = torch.arange(-r, r + 1, dtype=torch.float32, device=p_lvl.device)
    H, W = pimg.shape

    def clip_corner(c):
        return torch.stack([torch.clamp(c[:, 0], 0, max(W - P, 0)),
                            torch.clamp(c[:, 1], 0, max(H - P, 0))], dim=-1)

    corner = clip_corner(torch.round(p_lvl).to(torch.int32) - ph)
    corner_c = clip_corner(torch.round(p_lvl + flow).to(torch.int32) - ph)
    return r, P, offs1d, corner, corner_c


def _track_status(p_lvl, flow, xs0_c, ys0_c, r, P, H, W):
    """Tracked window inside the image and inside the sliced current patch."""
    tracked = p_lvl + flow
    inside = ((tracked[:, 0] >= r) & (tracked[:, 0] < W - r - 1)
              & (tracked[:, 1] >= r) & (tracked[:, 1] < H - r - 1))
    in_patch = ((xs0_c[:, 0] + flow[:, 0] >= 0.0) & (xs0_c[:, -1] + flow[:, 0] <= P - 1)
                & (ys0_c[:, 0] + flow[:, 1] >= 0.0) & (ys0_c[:, -1] + flow[:, 1] <= P - 1))
    return inside & in_patch


def _lk_level(pimg, cimg, p_lvl, status, flow, cfg: VisualConfig, compute_err: bool):
    """One pyramid level of Lucas-Kanade iterations.  Returns
    (flow, status, err or None)."""
    H, W = pimg.shape
    r, P, offs1d, corner, corner_c = _level_geometry(pimg, p_lvl, flow, cfg)
    w = 2 * r + 1

    Tp, Cp = gather_patches_pair(pimg, cimg, corner, corner_c, P)
    Gxp, Gyp = _patch_sobel(Tp)

    # template window (fixed per level): patch-space coords of the window taps
    xs0 = (p_lvl[:, 0] - corner[:, 0].to(torch.float32))[:, None] + offs1d
    ys0 = (p_lvl[:, 1] - corner[:, 1].to(torch.float32))[:, None] + offs1d
    Wx0, Wy0 = _tent_weights(xs0, P), _tent_weights(ys0, P)
    T = _sample_windows(Tp, Wy0, Wx0)
    Ix = _sample_windows(Gxp, Wy0, Wx0)
    Iy = _sample_windows(Gyp, Wy0, Wx0)
    inv00, inv01, inv11, ok_g = _window_hessian(Ix, Iy, w, cfg)

    xs0_c = p_lvl[:, 0:1] + offs1d - corner_c[:, 0:1].to(torch.float32)
    ys0_c = p_lvl[:, 1:2] + offs1d - corner_c[:, 1:2].to(torch.float32)
    flow = _gn_iterations(Cp, T, Ix, Iy, inv00, inv01, inv11, xs0_c, ys0_c, flow,
                          ok_g & status, cfg, P)

    status = status & ok_g & _track_status(p_lvl, flow, xs0_c, ys0_c, r, P, H, W)
    err = None
    if compute_err:
        # photometric residual at convergence: mean |I1(x+d) - I0(x)| over the window
        Cw = _sample_windows(Cp, _tent_weights(ys0_c + flow[:, 1:2], P),
                             _tent_weights(xs0_c + flow[:, 0:1], P))
        err = torch.mean(torch.abs(Cw - T), dim=(1, 2))
    return flow, status, err


def _lk_level_fb(pimg, cimg, p_lvl, status, flow, cfg: VisualConfig):
    """Fused forward + backward final level: the backward pass reuses the
    forward pass's two patches with their roles swapped (no new gather).
    Returns (flow, status, err, fb_err)."""
    H, W = pimg.shape
    r, P, offs1d, corner, corner_c = _level_geometry(pimg, p_lvl, flow, cfg)
    w = 2 * r + 1

    Tp, Cp = gather_patches_pair(pimg, cimg, corner, corner_c, P)
    Gxp, Gyp = _patch_sobel(Tp)

    # ---- forward (identical to _lk_level) ----------------------------------
    xs0 = (p_lvl[:, 0] - corner[:, 0].to(torch.float32))[:, None] + offs1d
    ys0 = (p_lvl[:, 1] - corner[:, 1].to(torch.float32))[:, None] + offs1d
    Wx0, Wy0 = _tent_weights(xs0, P), _tent_weights(ys0, P)
    T = _sample_windows(Tp, Wy0, Wx0)
    Ix = _sample_windows(Gxp, Wy0, Wx0)
    Iy = _sample_windows(Gyp, Wy0, Wx0)
    inv00, inv01, inv11, ok_g = _window_hessian(Ix, Iy, w, cfg)

    xs0_c = p_lvl[:, 0:1] + offs1d - corner_c[:, 0:1].to(torch.float32)
    ys0_c = p_lvl[:, 1:2] + offs1d - corner_c[:, 1:2].to(torch.float32)
    flow = _gn_iterations(Cp, T, Ix, Iy, inv00, inv01, inv11, xs0_c, ys0_c, flow,
                          ok_g & status, cfg, P)
    status = status & ok_g & _track_status(p_lvl, flow, xs0_c, ys0_c, r, P, H, W)

    # forward photometric residual (also the backward template, T_b)
    Wxb = _tent_weights(xs0_c + flow[:, 0:1], P)
    Wyb = _tent_weights(ys0_c + flow[:, 1:2], P)
    T_b = _sample_windows(Cp, Wyb, Wxb)
    err = torch.mean(torch.abs(T_b - T), dim=(1, 2))

    # ---- backward: roles swapped, patches reused ----------------------------
    Gxc, Gyc = _patch_sobel(Cp)
    Ixb = _sample_windows(Gxc, Wyb, Wxb)
    Iyb = _sample_windows(Gyc, Wyb, Wxb)
    b00, b01, b11, ok_b = _window_hessian(Ixb, Iyb, w, cfg)
    # a zero backward flow lands exactly on the feature (taps xs0/ys0), so
    # fb_err = |flow_b|^2
    flow_b = _gn_iterations(Tp, T_b, Ixb, Iyb, b00, b01, b11, xs0, ys0,
                            torch.zeros_like(flow), ok_b & status, cfg, P,
                            n_iters=cfg.klt_fb_iters)
    fb_err = torch.sum(flow_b ** 2, dim=-1)
    return flow, status & ok_b, err, fb_err


def _coarse_flow(prev_img, curr_img, pts, mask, cfg: VisualConfig, init_flow, skip_coarse):
    """The coarse pyramid levels.  ``skip_coarse`` is a host bool (or None
    for "run"): once a motion prior exists its seeded flow lands inside the
    level-0 patch slack and the coarse levels are skipped."""
    init = torch.zeros_like(pts) if init_flow is None else init_flow
    L = cfg.klt_levels
    if L == 0 or skip_coarse:
        return init, mask
    prev_pyr = gaussian_pyramid(prev_img, L)
    curr_pyr = gaussian_pyramid(curr_img, L)
    flow = init / (2.0 ** L)
    st = mask
    for lvl in range(L, 0, -1):
        flow, st, _ = _lk_level(prev_pyr[lvl], curr_pyr[lvl], pts / (2.0 ** lvl), st, flow,
                                cfg, False)
        flow = flow * 2.0
    return flow, st


def lk_track(prev_img, curr_img, pts, mask, cfg: VisualConfig, init_flow=None,
             return_err: bool = False, skip_coarse: bool | None = None):
    """Pyramidal Lucas-Kanade: (curr_pts (N, 2), status (N,)[, err (N,)])."""
    flow, status = _coarse_flow(prev_img, curr_img, pts, mask, cfg, init_flow, skip_coarse)
    flow, status, err = _lk_level(prev_img, curr_img, pts, status, flow, cfg, True)
    if return_err:
        return pts + flow, status, err
    return pts + flow, status


def lk_track_fb(prev_img, curr_img, pts, mask, cfg: VisualConfig, init_flow=None,
                skip_coarse: bool | None = None):
    """LK with the forward-backward consistency check and the photometric
    gate: (curr_pts (N, 2), ok (N,))."""
    flow, status = _coarse_flow(prev_img, curr_img, pts, mask, cfg, init_flow, skip_coarse)
    flow, status, err, fb_err = _lk_level_fb(prev_img, curr_img, pts, status, flow, cfg)
    ok = status & (fb_err < cfg.klt_fb_threshold ** 2) & (err < cfg.klt_max_err)
    return pts + flow, ok
