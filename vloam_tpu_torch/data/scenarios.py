"""Coupling-mode stress scenarios: worlds where the (C)/(D) switch matters
(a NumPy copy of ``vloam_tpu/data/scenarios.py``; tests check that it gives
the same arrays).

* ``corridor``: lidar-degenerate geometry (smooth parallel walls and ground,
  every surface normal perpendicular to the driving direction).  LO alone
  cannot observe forward motion, so the decoupled warm start never picks up
  speed, while the coupled VO seed supplies it from the wall texture:
  coupled (C) must win.  ``scan.exclude_unreliable`` removes the far
  grazing arcs whose false edges erode the coupled seed.
* ``highway``: sparse structure and a lead vehicle followed at a constant
  gap.  Camera features concentrate on the truck (zero apparent motion), so
  the VO seed collapses toward identity and LO's Huber loss keeps the
  truck-relative basin: coupled (C) must degrade, the KITTI seq-01
  signature of the reference's Table I.
* ``route_world`` / ``raycast_blob_anchors``: boxes, poles and surface
  texture along an arbitrary route (the urban-turn course).

``run_scenario`` drives the port's ``VloamDriver.process`` on ``device``
(``"cuda"`` unless the caller asks for the CPU) and scores the MO chain;
``compare_modes`` runs it in (D) and (C).
"""

from __future__ import annotations

import numpy as np

from vloam_tpu_torch.data import synthetic


# ---------------------------------------------------------------------------
# corridor: lidar-degenerate, camera-observable
# ---------------------------------------------------------------------------

def corridor_scene(length: float = 300.0, half_width: float = 7.0) -> np.ndarray:
    """Two smooth walls along +x plus the implicit ground plane.  Every
    surface is translation-invariant along x: LO's point-to-plane and
    point-to-line residuals have a null direction along the corridor."""
    w = 1.2
    return np.array(
        [
            [-40.0, half_width, -1.7, length + 60.0, half_width + w, 4.0],
            [-40.0, -half_width - w, -1.7, length + 60.0, -half_width, 4.0],
        ],
        np.float64,
    )


def corridor_texture(
    length: float = 300.0, half_width: float = 7.0, spacing: float = 1.2,
    seed: int = 3,
) -> np.ndarray:
    """World-frame blob anchors ON the inner wall faces (posters/stains):
    camera-trackable texture whose lidar depth the walls themselves supply.
    Spacing is kept > the KLT window's world footprint at typical viewing
    distances — overlapping blobs at different depths inside one 15-px
    tracking window mix depths and bias the VO scale."""
    rng = np.random.default_rng(seed)
    xs = np.arange(-20.0, length + 40.0, spacing)
    pts = []
    for side in (+1.0, -1.0):
        x = xs + rng.uniform(-0.3, 0.3, len(xs))
        y = np.full_like(x, side * (half_width - 0.02))
        z = rng.uniform(-1.2, 3.6, len(xs))
        pts.append(np.stack([x, y, z], -1))
    return np.concatenate(pts)


# ---------------------------------------------------------------------------
# highway: dynamic lead vehicle + sparse structure
# ---------------------------------------------------------------------------

def highway_static_scene(length: float = 400.0) -> np.ndarray:
    """Ground + low guardrails (x-invariant) + dense on-ramp poles for the
    first 30 m (so decoupled LO can lock onto the true velocity before the
    structure thins out) + rare posts afterwards."""
    boxes = [
        # guardrails: long, low, x-invariant
        [-40.0, 5.8, -1.7, length + 60.0, 6.2, -0.7],
        [-40.0, -6.2, -1.7, length + 60.0, -5.8, -0.7],
    ]
    rng = np.random.default_rng(9)
    # on-ramp poles: every 4 m, both sides, x in [-10, 30]
    for x in np.arange(-10.0, 30.0, 4.0):
        for side in (1.0, -1.0):
            xo = x + rng.uniform(-0.5, 0.5)
            boxes.append([xo, side * 6.8, -1.7, xo + 0.3, side * 6.8 + 0.3, 3.2])
    # lamp posts afterwards: every 25 m (static structure stays observable —
    # the seq-01 failure is basin selection, not absence of structure: at the
    # truck-locked seed the posts are Huber outliers, at the warm-start seed
    # they are the inliers)
    for x in np.arange(55.0, length + 40.0, 25.0):
        for side in (1.0, -1.0):
            boxes.append([x, side * 7.0, -1.7, x + 0.35, side * 7.0 + 0.35, 4.5])
    return np.array(boxes, np.float64)


def truck_box(x_rear: float) -> np.ndarray:
    """Lead-vehicle box: rear face (normal -x) at ``x_rear``, 2.8 m wide,
    2.9 m tall — lidar-visible, so its camera features get real depth."""
    return np.array([[x_rear, -1.4, -1.7, x_rear + 4.5, 1.4, 1.2]], np.float64)


def truck_texture(x_rear: float, seed: int = 4) -> np.ndarray:
    """Blob anchors on the truck's rear face (lights, logos, dirt)."""
    rng = np.random.default_rng(seed)  # same pattern every frame: it RIDES the truck
    y = rng.uniform(-1.3, 1.3, 60)
    z = rng.uniform(-1.4, 1.0, 60)
    return np.stack([np.full_like(y, x_rear - 0.02), y, z], -1)


def highway_static_texture(length: float = 400.0) -> np.ndarray:
    """Sparse static texture: marks on guardrail tops + the posts."""
    rng = np.random.default_rng(6)
    xs = np.arange(-10.0, length + 40.0, 12.0)
    pts = []
    for side in (1.0, -1.0):
        x = xs + rng.uniform(-2, 2, len(xs))
        pts.append(np.stack([x, np.full_like(x, side * 5.95), np.full_like(x, -0.72)], -1))
    return np.concatenate(pts)


def highway_speeds(n_frames: int, v_max: float = 2.2, accel: float = 0.15) -> np.ndarray:
    """On-ramp acceleration profile: v_i = min(v_max, 0.4 + accel*i)."""
    return np.minimum(v_max, 0.4 + accel * np.arange(n_frames))


def straight_poses_from_speeds(speeds: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
    poses = []
    x = 0.0
    for v in speeds:
        poses.append((np.eye(3), np.array([x, 0.0, 0.0])))
        x += float(v)
    return poses


# ---------------------------------------------------------------------------
# generic runner
# ---------------------------------------------------------------------------

def run_scenario(
    cfg,
    poses: list[tuple[np.ndarray, np.ndarray]],
    boxes_fn,                 # i -> (B, 6) world boxes for frame i
    texture_fn,               # i -> (M, 3) world blob anchors for frame i
    n_azimuth: int = 900,
    noise: float = 0.005,
    verbose: bool = False,
    device="cuda",
) -> dict:
    """Drive the FULL pipeline (VloamDriver.process) through a scenario and
    score the MO chain against the exact trajectory."""
    from vloam_tpu_torch.data.stream import camera_matrices
    from vloam_tpu_torch.models import frame_graph as fg
    from vloam_tpu_torch.runtime.driver import VloamDriver, resolve_device

    dev = resolve_device(device)
    ext = fg.kitti_default_extrinsics(dev)
    K = camera_matrices(ext)[0]
    vc = cfg.visual
    driver = VloamDriver(cfg, ext, device=dev)

    mo, vo = [], []
    for i, (R, t) in enumerate(poses):
        cloud = synthetic.simulate_scan(
            R, t, boxes_fn(i), n_azimuth=n_azimuth, noise=noise, seed=i
        )
        R_wc = R @ synthetic.CAM_R_WORLD.T
        img = synthetic.render_blob_image(
            (texture_fn(i) - t) @ R_wc, K, vc.img_height, vc.img_width
        )
        driver.process(img, cloud)
        mo.append(driver.host_out.world_mo)
        vo.append(driver.host_out.world_vo)
        if verbose and i % 10 == 0:
            err = np.linalg.norm(mo[-1][4:] - t)
            print(f"  frame {i:3d}  MO err {err:7.3f} m")
    driver.close()

    mo, vo = np.stack(mo), np.stack(vo)
    gt = np.stack([t for _, t in poses])
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    final_err = float(np.linalg.norm(mo[-1, 4:] - gt[-1]))
    ate = float(np.mean(np.linalg.norm(mo[:, 4:] - gt, axis=1)))

    # forward-progress ratio: how much of the true advance the estimate made
    # (the degenerate-axis failure signature is progress ~ 0)
    def progress(chain):
        return float(
            (chain[-1, 4] - chain[0, 4]) / max(gt[-1, 0] - gt[0, 0], 1e-9)
        )

    return {
        "mode": "coupled_C" if not cfg.detach_vo_lo else "decoupled_D",
        "frames": len(poses),
        "path_len_m": round(path, 1),
        "final_err_m": round(final_err, 3),
        "final_err_pct": round(100.0 * final_err / path, 2),
        "ate_m": round(ate, 3),
        "x_progress_ratio": round(progress(mo), 3),
        "vo_x_progress_ratio": round(progress(vo), 3),
    }


def compare_modes(cfg, poses, boxes_fn, texture_fn, **kw) -> dict:
    """Run a scenario in decoupled (D) and coupled (C) modes."""
    res = {}
    for detach in (True, False):
        c = cfg.replace(detach_vo_lo=detach)
        r = run_scenario(c, poses, boxes_fn, texture_fn, **kw)
        res[r["mode"]] = r
    return res


def route_world(poses, seed: int = 21, sparse_every: int = 3,
                sparse_keep: float = 0.25) -> np.ndarray:
    """Boxes + poles lining both sides of an arbitrary route (the urban-turn
    coupling course); every ``sparse_every``-th
    straight block is thinned to ``sparse_keep`` density (mild LO
    degeneracy — ground + sparse poles, not a corridor collapse)."""
    rng = np.random.default_rng(seed)
    pts = np.stack([t for _, t in poses])
    boxes = []
    d = np.diff(pts, axis=0)
    seg = np.linalg.norm(d, axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = cum[-1]
    s = 0.0
    while s < total:
        i = int(np.searchsorted(cum, s, side="right")) - 1
        i = min(i, len(d) - 1)
        p = pts[i] + d[i] * ((s - cum[i]) / max(seg[i], 1e-9))
        tang = d[i] / max(seg[i], 1e-9)
        norm = np.array([-tang[1], tang[0], 0.0])
        block = int(s // 78.0)       # ~one straight+turn period at speed 1.1
        sparse = sparse_every and (block % sparse_every == sparse_every - 1)
        for side in (+1.0, -1.0):
            if sparse and rng.uniform() > sparse_keep:
                continue
            off = side * (14.0 + rng.uniform(-2.0, 2.0))
            x, y = p[0] + norm[0] * off, p[1] + norm[1] * off
            if rng.uniform() < 0.35:
                boxes.append([x, y, -1.7, x + 0.3, y + 0.3,
                              rng.uniform(2.5, 4.5)])
            else:
                w, dd = rng.uniform(3, 8), rng.uniform(3, 8)
                boxes.append([x, y, -1.7, x + w, y + dd,
                              -1.7 + rng.uniform(4, 14)])
        s += 9.0
    return np.array(boxes, np.float64)


def raycast_blob_anchors(poses, world, K, img_h: int, img_w: int,
                         every: int = 8, n_uv: int = 600,
                         radius: float = 90.0, seed: int = 11):
    """Camera texture for an arbitrary route: every ``every`` frames,
    raycast random pixels against the world and keep the hit points as
    world-frame blob anchors (texture lives ON surfaces, so the lidar depth
    the VO associates is consistent).  Returns texture_fn(i) for
    run_scenario."""
    rng = np.random.default_rng(seed)
    anchors = np.zeros((0, 3))
    per_frame = []
    for i, (R, t) in enumerate(poses):
        R_wc = R @ synthetic.CAM_R_WORLD.T
        if i % every == 0:
            uv = np.stack([rng.uniform(20, img_w - 20, n_uv),
                           rng.uniform(20, img_h - 20, n_uv)], -1)
            pc, hit = synthetic.raycast_camera(R_wc, t, world, K, uv)
            anchors = np.concatenate([anchors, (pc[hit] @ R_wc.T) + t])
        per_frame.append(anchors[np.linalg.norm(anchors - t, axis=1) < radius])
    return lambda i: per_frame[i]
