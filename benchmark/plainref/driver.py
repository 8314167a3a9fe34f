"""The plain driver: ``VloamDriver.process`` of ``vloam_tpu_torch/runtime/
driver.py`` at commit 2b93434, cut to what the benchmark's comparison needs.

Per frame: the ring grid, the depth buckets and the less-flat table in NumPy
(``data/gridding``: the tables with the arithmetic of the host library that
the program's driver calls),
the plain frame step, one fetch of the deltas and world poses, the float64
host chains and the exported KITTI rows, kept in memory instead of written.
No debug dumps, checkpoints, refinement or loop closure.
"""

from __future__ import annotations

import numpy as np
import torch

from plainref import geometry_np as gnp
from plainref.config import VloamConfig
from plainref.data.gridding import depth_buckets, grid_cloud, less_flat_voxel_table
from plainref.models import frame_graph as fg
from plainref.models.vloam import host_to_device, init_vloam_state, vloam_step
from plainref.ops.depth_map import DepthBuckets

HOST_POSE_FIELDS = ("vo_delta", "lo_delta", "mo_correction", "world_vo", "world_lo", "world_mo")


def pad_image(img: np.ndarray, cfg: VloamConfig) -> np.ndarray:
    vc = cfg.visual
    out = np.zeros((vc.img_height, vc.img_width), np.float32)
    h = min(img.shape[0], vc.img_height)
    w = min(img.shape[1], vc.img_width)
    out[:h, :w] = img[:h, :w]
    return out


class PlainDriver:
    """Replays frames through the plain step; ``rows[c]`` holds chain c's
    ("vo", "lo", "mo") exported float64 poses cam0_start_T_cam0_curr."""

    def __init__(self, cfg: VloamConfig, device):
        self.device = torch.device(device)
        self.cfg = cfg
        self.ext = fg.kitti_default_extrinsics(self.device)
        self.state = init_vloam_state(cfg, self.device)
        e = self.ext
        self._proj = (e.P_rect0 @ e.R_rect0 @ e.cam_T_velo).cpu().numpy()
        self._base_T_cam0_64 = gnp.as_pose64(e.base_T_cam0.cpu().numpy())
        self._w = {c: gnp.pose_identity() for c in ("vo", "lo", "mo")}
        self._anchor64 = None
        self.rows = {c: [] for c in ("vo", "lo", "mo")}

    def process(self, image: np.ndarray, cloud: np.ndarray) -> None:
        cfg, dev = self.cfg, self.device
        grid, gmask, _ = grid_cloud(cloud.astype(np.float32), cfg.scan)
        img = pad_image(image, cfg)
        bu, bv, bz, bc = depth_buckets(grid.reshape(-1, 4), gmask.reshape(-1), self._proj,
                                       cfg.visual)
        buckets = DepthBuckets(*(host_to_device(b, dev) for b in (bu, bv, bz, bc)))
        sg, bs, nr = less_flat_voxel_table(grid, gmask, cfg.scan)
        lf_table = (host_to_device(sg, dev), host_to_device(bs, dev), int(nr))
        self.state, out = vloam_step(
            self.state, host_to_device(img, dev), host_to_device(grid, dev),
            host_to_device(gmask, dev), self.ext, cfg, pre_gridded=True,
            pre_buckets=buckets, pre_lf_table=lf_table)
        packed = torch.cat([getattr(out, n) for n in HOST_POSE_FIELDS]).cpu().numpy()
        self._accumulate_f64(dict(zip(HOST_POSE_FIELDS, packed.reshape(-1, 7))))
        for c in ("vo", "lo", "mo"):
            self.rows[c].append(self._export_row(self._w[c]))

    def _accumulate_f64(self, out: dict) -> None:
        vo_d = np.asarray(out["vo_delta"], np.float64)
        lo_d = np.asarray(out["lo_delta"], np.float64)
        mo_c = np.asarray(out["mo_correction"], np.float64)
        if np.all(np.isfinite(vo_d)):
            self._w["vo"] = gnp.pose_compose(self._w["vo"], gnp.as_pose64(vo_d))
        if np.all(np.isfinite(lo_d)):
            self._w["lo"] = gnp.pose_compose(self._w["lo"], gnp.as_pose64(lo_d))
        if np.all(np.isfinite(mo_c)):
            self._w["mo"] = gnp.pose_compose(gnp.as_pose64(mo_c), self._w["lo"])
        if self._anchor64 is None:
            b = self._base_T_cam0_64
            self._anchor64 = gnp.pose_compose(
                gnp.pose_compose(gnp.pose_inverse(b), self._w["vo"]), b)

    def _export_row(self, world64: np.ndarray) -> np.ndarray:
        b = self._base_T_cam0_64
        cam = gnp.pose_compose(gnp.pose_compose(gnp.pose_inverse(b), world64), b)
        return gnp.pose_compose(gnp.pose_inverse(self._anchor64), cam)
