"""KITTI raw-dataset loader — reference: point_cloud_util.cpp:24-176 +
the rosbag replay driver (vloam_main_node.cpp:226-232).

The reference replays kitti2bag rosbags through ROS; here we read the raw
dataset directly (no ROS):

  <root>/<date>/calib_velo_to_cam.txt          (keys R:, T:)
  <root>/<date>/calib_cam_to_cam.txt           (keys R_rect_00:, P_rect_00:)
  <root>/<date>/calib_imu_to_velo.txt          (keys R:, T:)
  <root>/<date>/<date>_drive_<seq>_sync/velodyne_points/data/NNNNNNNNNN.bin
  <root>/<date>/<date>_drive_<seq>_sync/image_00/data/NNNNNNNNNN.png

Also understands the KITTI *odometry* benchmark layout:
  <root>/sequences/<NN>/velodyne/NNNNNN.bin, image_0/NNNNNN.png, calib.txt

Host-side NumPy; ``runtime/native.NativePrefetcher`` offers the same frames with
asynchronous readahead (``runtime/driver.run_kitti`` uses it when the library is built).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def _parse_kv_floats(path: str) -> dict[str, np.ndarray]:
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, _, rest = line.partition(":")
            try:
                out[key.strip()] = np.array([float(t) for t in rest.split()], np.float64)
            except ValueError:
                continue
    return out


@dataclass
class KittiCalib:
    cam_T_velo: np.ndarray   # (4, 4) — unrectified cam00 from velodyne (R:, T: of calib_velo_to_cam)
    rect0_T_cam: np.ndarray  # (4, 4) — R_rect_00 homogeneous
    P_rect0: np.ndarray      # (3, 4)
    velo_T_imu: np.ndarray   # (4, 4) (identity if calib_imu_to_velo absent)

    @property
    def proj(self) -> np.ndarray:
        """(3, 4) full velodyne->image projection (point_cloud_util.cpp:191-193)."""
        return (self.P_rect0 @ self.rect0_T_cam @ self.cam_T_velo).astype(np.float32)

    @property
    def K(self) -> np.ndarray:
        return self.P_rect0[:, :3].astype(np.float32)


def _rt_to_mat(kv: dict, rkey: str = "R", tkey: str = "T") -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = kv[rkey].reshape(3, 3)
    m[:3, 3] = kv[tkey]
    return m


def load_calib_raw(date_dir: str) -> KittiCalib:
    v2c = _parse_kv_floats(os.path.join(date_dir, "calib_velo_to_cam.txt"))
    c2c = _parse_kv_floats(os.path.join(date_dir, "calib_cam_to_cam.txt"))
    cam_T_velo = _rt_to_mat(v2c)
    rect = np.eye(4)
    rect[:3, :3] = c2c["R_rect_00"].reshape(3, 3)
    P = c2c["P_rect_00"].reshape(3, 4)
    imu_path = os.path.join(date_dir, "calib_imu_to_velo.txt")
    velo_T_imu = _rt_to_mat(_parse_kv_floats(imu_path)) if os.path.exists(imu_path) else np.eye(4)
    return KittiCalib(cam_T_velo, rect, P, velo_T_imu)


def load_calib_odometry(seq_dir: str) -> KittiCalib:
    kv = _parse_kv_floats(os.path.join(seq_dir, "calib.txt"))
    P0 = kv["P0"].reshape(3, 4)
    cam_T_velo = np.eye(4)
    cam_T_velo[:3, :] = kv["Tr"].reshape(3, 4)
    return KittiCalib(cam_T_velo, np.eye(4), P0, np.eye(4))


def load_bin(path: str) -> np.ndarray:
    """Velodyne .bin -> (N, 3) float32 xyz (drops reflectance; loader
    semantics of point_cloud_util.cpp:148-176)."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return raw[:, :3]


def load_image(path: str) -> np.ndarray:
    """Grayscale image -> (H, W) float32 in [0, 255]."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), np.float32)


@dataclass
class Frame:
    index: int
    cloud: np.ndarray          # (N, 3)
    image: np.ndarray | None   # (H, W) or None (lidar-only mode)


class RawSequence:
    """Iterates synchronized (image, cloud) frames of a KITTI raw drive."""

    def __init__(self, root: str, date: str, seq: str, with_images: bool = True):
        self.date_dir = os.path.join(root, date)
        drive = f"{date}_drive_{seq}_sync"
        self.drive_dir = os.path.join(self.date_dir, drive)
        self.calib = load_calib_raw(self.date_dir)
        self.velo_dir = os.path.join(self.drive_dir, "velodyne_points", "data")
        self.img_dir = os.path.join(self.drive_dir, "image_00", "data")
        self.with_images = with_images and os.path.isdir(self.img_dir)
        self.files = sorted(os.listdir(self.velo_dir))

    def __len__(self) -> int:
        return len(self.files)

    def frame(self, i: int) -> Frame:
        stem = os.path.splitext(self.files[i])[0]
        cloud = load_bin(os.path.join(self.velo_dir, self.files[i]))
        img = (
            load_image(os.path.join(self.img_dir, stem + ".png")) if self.with_images else None
        )
        return Frame(i, cloud, img)

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)


class OdometrySequence:
    """KITTI odometry benchmark layout (sequences/NN)."""

    def __init__(self, root: str, seq: str, with_images: bool = True):
        self.seq_dir = os.path.join(root, "sequences", seq)
        self.calib = load_calib_odometry(self.seq_dir)
        self.velo_dir = os.path.join(self.seq_dir, "velodyne")
        self.img_dir = os.path.join(self.seq_dir, "image_0")
        self.with_images = with_images and os.path.isdir(self.img_dir)
        self.files = sorted(os.listdir(self.velo_dir))

    def __len__(self) -> int:
        return len(self.files)

    def frame(self, i: int) -> Frame:
        stem = os.path.splitext(self.files[i])[0]
        cloud = load_bin(os.path.join(self.velo_dir, self.files[i]))
        img = (
            load_image(os.path.join(self.img_dir, stem + ".png")) if self.with_images else None
        )
        return Frame(i, cloud, img)

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)
