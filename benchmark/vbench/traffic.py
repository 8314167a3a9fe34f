"""The benchmark's traffic generator: synthetic KITTI-rig drives, made on the
device from the seed in set-up.

A copy of the semantics of ``vloam_tpu_torch/data/synthetic.py``
(``default_scene``, ``hdl64_ring_angles``, ``simulate_scan``,
``snake_trajectory``, ``raycast_camera``, ``render_blob_image``) and of
``vloam_tpu_torch/data/stream.gen_raw`` (persistent blob texture, near-box
culling), as they stood at commit 2b93434, rewritten in PyTorch so that a
drive is raycast on the card instead of on the host.  Departures, all set
by the traffic file: the street's buildings and poles are drawn along the
whole course from the seed (``default_scene`` lays 30 and 25 from a fixed
seed); the snake course's phase is drawn from the seed; each blob keeps the
amplitude it was drawn with (``render_blob_image`` draws the amplitudes of
the visible blobs anew every frame); the scan noise is drawn for every ray
and kept for the hits.

A drive is a list of (image (H, W) float32, cloud (N, 3) float32) NumPy
pairs in the sensor frame, and its exact sensor poses (R, t) in float64.
The same (seed, drive index) gives the same arrays bit for bit: every draw
comes from one ``torch.Generator`` seeded from both, and the one scattered
accumulation (the blob splats) sums in a fixed order (``scatter_sum``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# KITTI-style camera axes in the lidar/world convention (synthetic.CAM_R_WORLD)
CAM_R_WORLD = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])


def drive_seed(seed: int, drive: int) -> int:
    """A 63-bit generator seed from the run's seed and the drive's index."""
    words = np.random.SeedSequence([seed % 2**64, drive]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def hdl64_ring_angles() -> np.ndarray:
    """Degrees, rings 0..63 (synthetic.hdl64_ring_angles)."""
    upper = 2.0 - np.arange(32) / 3.0
    lower = -8.87 - np.arange(32) / 2.0
    return np.concatenate([upper, lower])


def snake_course(n: int, speed: float, yaw_amp: float, period: float, phase: float):
    """Sensor poses (R (n, 3, 3), t (n, 3)) float64 weaving along +x
    (synthetic.snake_trajectory with the yaw rate's phase shifted)."""
    R = np.zeros((n, 3, 3))
    t = np.zeros((n, 3))
    yaw, pos = 0.0, np.zeros(3)
    for i in range(n):
        c, s = math.cos(yaw), math.sin(yaw)
        R[i] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
        t[i] = pos
        pos = pos + R[i] @ np.array([speed, 0.0, 0.0])
        yaw += yaw_amp * math.sin(2.0 * math.pi * (i + phase) / period)
    return R, t


def _uniform(gen, n, lo_hi, dev):
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(n, generator=gen, dtype=torch.float64, device=dev)


def street_scene(tr: dict, x_end: float, gen, dev) -> torch.Tensor:
    """(B, 6) boxes (x0, y0, z0, x1, y1, z1): buildings on alternating sides
    and thin poles, laid from the traffic's start out to ``x_end``
    (synthetic.default_scene's rules)."""
    b, p = tr["buildings"], tr["poles"]
    nb = int(math.ceil((x_end - b["start_x"]) / b["spacing_m"]))
    x = b["start_x"] + b["spacing_m"] * torch.arange(nb, dtype=torch.float64, device=dev)
    w = _uniform(gen, nb, b["width_m"], dev)
    d = _uniform(gen, nb, b["depth_m"], dev)
    h = _uniform(gen, nb, b["height_m"], dev)
    side = torch.where(torch.arange(nb, device=dev) % 2 == 0, 1.0, -1.0).to(torch.float64)
    y0 = side * _uniform(gen, nb, b["setback_m"], dev)
    y1 = y0 + side * d
    z0 = torch.full_like(x, b["base_z"])
    build = torch.stack([x, torch.minimum(y0, y1), z0, x + w, torch.maximum(y0, y1), z0 + h], 1)
    npl = int(math.ceil((x_end - p["start_x"]) / p["spacing_m"]))
    i = torch.arange(npl, dtype=torch.float64, device=dev)
    px = p["start_x"] + p["spacing_m"] * i + _uniform(gen, npl, (-p["jitter_m"], p["jitter_m"]),
                                                      dev)
    py = torch.where(i % 2 == 1, 1.0, -1.0).to(torch.float64) * _uniform(gen, npl,
                                                                         p["offset_m"], dev)
    pz = torch.full_like(px, b["base_z"])
    s = p["size_m"]
    poles = torch.stack([px, py, pz, px + s, py + s, torch.full_like(px, p["top_z"])], 1)
    return torch.cat([build, poles])


def ray_hits(origins, dirs, boxes, ground_z, max_range):
    """Nearest hit distance of each ray over the boxes and the ground
    plane, +inf past ``max_range`` (synthetic._ray_aabb and the ground test
    of simulate_scan).  ``origins`` (..., 3), ``dirs`` (..., R, 3) unit:
    one origin for each leading index (a frame), R rays from it."""
    o = origins[..., None, :]                                       # (..., 1, 3)
    inv = 1.0 / torch.where(dirs.abs() < 1e-12, torch.full_like(dirs, 1e-12), dirs)
    t0 = (boxes[:, :3] - o[..., None, :]) * inv[..., None, :]       # (..., R, B, 3)
    t1 = (boxes[:, 3:] - o[..., None, :]) * inv[..., None, :]
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    hit = (tmax >= tmin) & (tmax > 0) & (tmin > 0)
    if boxes.shape[0]:
        t_box = torch.where(hit, tmin, torch.inf).amin(-1)
    else:
        t_box = torch.full_like(dirs[..., 0], torch.inf)
    dz = dirs[..., 2]
    t_gnd = torch.where(dz < -1e-6, (ground_z - o[..., 2]) / torch.where(dz == 0, -1.0, dz),
                        torch.inf)
    t = torch.minimum(t_box, t_gnd)
    return torch.where(t < max_range, t, torch.inf)


def scatter_sum(img_flat, idx, val):
    """img_flat[idx] += val, deterministic: the values sorted by index
    (stable) and summed per index as differences of one float64 prefix sum,
    so no atomic addition orders them differently from run to run."""
    order = torch.argsort(idx, stable=True)
    idx, val = idx[order], val[order].to(torch.float64)
    uniq, counts = torch.unique_consecutive(idx, return_counts=True)
    ends = counts.cumsum(0) - 1
    cs = val.cumsum(0)
    seg = cs[ends] - torch.cat([cs.new_zeros(1), cs[ends[:-1]]])
    img_flat[uniq] += seg.to(img_flat.dtype)


def render_blobs(img_flat, base, uv, amp, height, width, sigma):
    """Splat Gaussian blobs at pixel positions ``uv`` (M, 2) into the flat
    float32 images ``img_flat``, blob m into the image that starts at
    ``base[m]`` (synthetic.render_blob_image's kernel and edge rule)."""
    r = int(3 * sigma) + 1
    ui, vi = torch.round(uv[:, 0]), torch.round(uv[:, 1])
    keep = (ui >= r) & (ui < width - r) & (vi >= r) & (vi < height - r)
    uv, amp, base = uv[keep], amp[keep], base[keep]
    ui, vi = ui[keep].long(), vi[keep].long()
    off = torch.arange(-r, r + 1, device=uv.device)
    ys = vi[:, None, None] + off[None, :, None]
    xs = ui[:, None, None] + off[None, None, :]
    val = amp[:, None, None] * torch.exp(
        -((xs - uv[:, 0, None, None]) ** 2 + (ys - uv[:, 1, None, None]) ** 2) / (2 * sigma ** 2))
    scatter_sum(img_flat, (base[:, None, None] + ys * width + xs).reshape(-1), val.reshape(-1))


def make_drive(tr: dict, height: int, width: int, K: np.ndarray, seed: int, drive: int,
               device, n_frames: int | None = None):
    """One drive of the traffic ``tr``: (frames, (R, t)).  ``frames`` is a
    list of (image (height, width) float32, cloud (N, 3) float32) NumPy
    pairs; ``n_frames`` cuts the drive short (tests).  The frames are made
    ``camera.every`` at a time, the blob texture extended at the first of
    each group."""
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    n = tr["frames_per_drive"] if n_frames is None else n_frames
    lid, cam = tr["lidar"], tr["camera"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(drive_seed(seed, drive))
    phase = float(torch.rand(1, generator=gen, **f64)) * tr["period"]
    R, t = snake_course(n, tr["speed_m"], tr["yaw_amp"], tr["period"], phase)
    boxes = street_scene(tr, float(t[:, 0].max()) + lid["near_m"], gen, dev)
    box_cx = 0.5 * (boxes[:, 0] + boxes[:, 3])

    el = torch.tensor(np.radians(hdl64_ring_angles()), **f64)
    az = torch.linspace(math.pi, -math.pi, lid["n_azimuth"] + 1, **f64)[:-1]  # clockwise
    azg, elg = torch.meshgrid(az, el, indexing="ij")           # azimuth-major order
    ce = torch.cos(elg)
    dirs_s = torch.stack([ce * torch.cos(azg), ce * torch.sin(azg), torch.sin(elg)],
                         -1).reshape(-1, 3)
    Kt = torch.tensor(K, **f64)
    Kinv = torch.linalg.inv(Kt)
    cam_r = torch.tensor(CAM_R_WORLD, **f64)
    blob_w = torch.zeros((0, 3), **f64)
    blob_a = torch.zeros((0,), **f64)
    lo_px = torch.tensor([cam["margin_px"], cam["margin_px"]], **f64)
    span_px = torch.tensor([width - 2 * cam["margin_px"], height - 2 * cam["margin_px"]], **f64)
    hw = height * width
    frames = []
    with torch.no_grad():
        for c0 in range(0, n, cam["every"]):
            c1 = min(c0 + cam["every"], n)
            Rb = torch.tensor(R[c0:c1], **f64)
            tb = torch.tensor(t[c0:c1], **f64)
            R_wc = Rb @ cam_r.T                                    # (B, 3, 3) camera to world
            near = boxes[(box_cx[:, None] - tb[:, 0]).abs().amin(1) < lid["near_m"]]
            # extend the persistent texture: raycast random pixels into the world
            uv = lo_px + span_px * torch.rand((cam["blobs"], 2), generator=gen, **f64)
            amp = _uniform(gen, cam["blobs"], cam["amp"], dev)
            rays = torch.cat([uv, torch.ones_like(uv[:, :1])], 1) @ Kinv.T
            rays = rays / rays.norm(dim=1, keepdim=True)
            d = ray_hits(tb[0], rays @ R_wc[0].T, near, lid["ground_z"], cam["range_m"])
            hit = torch.isfinite(d)
            blob_w = torch.cat([blob_w, (rays[hit] * d[hit, None]) @ R_wc[0].T + tb[0]])
            blob_a = torch.cat([blob_a, amp[hit]])
            # the scans
            d = ray_hits(tb, torch.einsum("rj,bij->bri", dirs_s, Rb), near, lid["ground_z"],
                         lid["max_range_m"])                       # (B, R)
            noise = lid["noise_m"] * torch.randn(d.shape + (3,), generator=gen, **f64)
            hit = torch.isfinite(d)
            pts = (dirs_s * d[..., None] + noise)[hit].to(torch.float32)
            counts = hit.sum(1)
            # the images: blobs within range, in front of the camera
            rel = blob_w - tb[:, None]                              # (B, M, 3)
            pc = torch.einsum("bmj,bjk->bmk", rel, R_wc)
            ok = (rel.norm(dim=-1) < cam["range_m"]) & (pc[..., 2] > 0.5)
            b_idx, m_idx = ok.nonzero(as_tuple=True)
            uvw = pc[b_idx, m_idx] @ Kt.T
            imgs = torch.zeros((c1 - c0) * hw, dtype=torch.float32, device=dev)
            render_blobs(imgs, b_idx * hw, uvw[:, :2] / uvw[:, 2:3], blob_a[m_idx],
                         height, width, cam["sigma_px"])
            imgs = imgs.clamp_(0.0, 255.0).reshape(c1 - c0, height, width).cpu().numpy()
            clouds = np.split(pts.cpu().numpy(), np.cumsum(counts.cpu().numpy())[:-1])
            frames.extend(zip(imgs, clouds))
    return frames, (R, t)
