"""Sequence driver: the frame loop of vloam_main_node.cpp:134-202 (port of
``vloam_tpu/runtime/driver.py``).

Feeds raw clouds and images (or pre-built ring grids) to ``vloam_step`` and
writes the reference's VO{d}.txt / LO{d}.txt / MO{d}.txt trajectory files
({d} = detach_VO_LO as 0/1, vloam_main_node.cpp:99-101), so the reference's
evaluation tooling applies unchanged.

World poses are accumulated twice: in f32 on the device (the coupling
state) and in float64 on the host from the per-frame deltas in VloamOutputs
(geometry_np; the reference leans on Ceres doubles,
laser_odometry.cpp:524-525).  Trajectory export reads the f64 chains; the
realised f32-vs-f64 divergence is tracked per chain (``f32_divergence_m``).

Per frame the host reads the device once: the three deltas, the three world
poses and the LO correspondence counts come back as one stacked tensor, and
the host arrays go up through pinned memory without blocking.

The device is ``"cuda"`` unless the caller passes another; a missing GPU
raises.  Not ported: the native C++ host library and its prefetcher
(ROADMAP A8), pose-graph refinement and loop closure (A10), debug PNGs (A9).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from vloam_tpu_torch import geometry as geo
from vloam_tpu_torch import geometry_np as gnp
from vloam_tpu_torch.config import VloamConfig
from vloam_tpu_torch.data import synthetic
from vloam_tpu_torch.data.gridding import depth_buckets, grid_cloud, less_flat_voxel_table
from vloam_tpu_torch.data.stream import camera_matrices
from vloam_tpu_torch.models import frame_graph as fg
from vloam_tpu_torch.models.vloam import (VloamOutputs, host_to_device, init_vloam_state,
                                          vloam_step)
from vloam_tpu_torch.ops.depth_map import DepthBuckets
from vloam_tpu_torch.utils.profiling import StageTimer
from vloam_tpu_torch.utils.trajectory import TrajectoryWriter

# the VloamOutputs fields the host chains and the degradation warning read
HOST_POSE_FIELDS = ("vo_delta", "lo_delta", "mo_correction", "world_vo", "world_lo", "world_mo")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for a GPU that is not there raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU")
    return dev


def extrinsics_from_calib(calib, device="cuda") -> fg.Extrinsics:
    """KittiCalib -> frame-graph Extrinsics.  base_link is taken as the
    velodyne frame (the reference's coupling chain conflates them anyway;
    exports are rebased to cam0@start so the choice cancels there)."""
    cam_T_velo = torch.tensor(np.asarray(calib.cam_T_velo), dtype=torch.float32)
    rect = torch.tensor(np.asarray(calib.rect0_T_cam), dtype=torch.float32)
    m = torch.linalg.inv(rect @ cam_T_velo)
    velo_T_cam0 = geo.pose_from_qt(geo.matrix_to_quat(m[:3, :3]), m[:3, 3]).to(device)
    return fg.Extrinsics(
        base_T_cam0=velo_T_cam0,
        velo_T_cam0=velo_T_cam0,
        cam_T_velo=cam_T_velo.to(device),
        P_rect0=torch.tensor(np.asarray(calib.P_rect0), dtype=torch.float32, device=device),
        R_rect0=rect.to(device),
    )


def pad_image(img: np.ndarray, cfg: VloamConfig) -> np.ndarray:
    vc = cfg.visual
    out = np.zeros((vc.img_height, vc.img_width), np.float32)
    h = min(img.shape[0], vc.img_height)
    w = min(img.shape[1], vc.img_width)
    out[:h, :w] = img[:h, :w]
    return out


class VloamDriver:
    """Owns the pipeline state, the host-side f64 pose chains, and exporters."""

    def __init__(
        self,
        cfg: VloamConfig,
        ext: fg.Extrinsics,
        out_dir: str | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 0,
        debug_dir: str | None = None,
        refine: bool = False,
        loop_closure: bool = False,
        device="cuda",
    ):
        if refine or loop_closure:
            raise NotImplementedError(
                "pose-graph refinement and loop closure (refine=True, loop_closure=True) are "
                "not ported yet (ROADMAP A10)")
        if debug_dir:
            raise NotImplementedError("debug PNG dumps (debug_dir) are not ported yet (ROADMAP A9)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ext = fg.Extrinsics(*(x.to(self.device) for x in ext))
        self.state = init_vloam_state(cfg, self.device)   # the cube map is updated in place
        self.timer = StageTimer()
        self.count = 0
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        # f64 host world chains, rebased from per-frame f32 deltas (module
        # docstring; reference: Ceres doubles).  _anchor64 is the f64 twin
        # of cam0_init_T_cam0_start, captured at frame 0.
        self._w_vo64 = gnp.pose_identity()
        self._w_lo64 = gnp.pose_identity()
        self._w_mo64 = gnp.pose_identity()
        self._anchor64: np.ndarray | None = None
        self.f32_divergence_m = {"vo": 0.0, "lo": 0.0, "mo": 0.0}
        self.host_out: VloamOutputs | None = None   # last frame's outputs the host read (NumPy)
        self._base_T_cam0_64 = gnp.as_pose64(ext.base_T_cam0.cpu().numpy())
        self._proj = camera_matrices(ext)[1]
        self.writers = {}
        self.out_dir = out_dir
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            d = int(cfg.detach_vo_lo)
            self.writers = {
                "vo": TrajectoryWriter(os.path.join(out_dir, f"VO{d}.txt")),
                "lo": TrajectoryWriter(os.path.join(out_dir, f"LO{d}.txt")),
                "mo": TrajectoryWriter(os.path.join(out_dir, f"MO{d}.txt")),
            }

    def save_checkpoint(self) -> None:
        """Snapshot the device state (``utils/checkpoint``) and the host
        driver state (<path>_driver.npz: the f64 chains, under the
        reference driver's keys) so a resumed run continues where an
        uninterrupted one would be."""
        from vloam_tpu_torch.utils.checkpoint import save_checkpoint

        path = os.path.join(self.checkpoint_dir, f"ckpt_{self.count:06d}")
        save_checkpoint(path, self.state, self.count)
        for w in self.writers.values():
            w.flush()
        np.savez(
            path + "_driver.npz",
            w_vo64=self._w_vo64, w_lo64=self._w_lo64, w_mo64=self._w_mo64,
            anchor64=(self._anchor64 if self._anchor64 is not None else np.zeros(0, np.float64)),
            divergence=np.array([self.f32_divergence_m[k] for k in ("vo", "lo", "mo")],
                                np.float64),
            # refinement history and loop-closure keyframes: not ported, always empty
            world_hist=np.zeros((0, 3, 7), np.float64),
            kf_ids=np.zeros((0,), np.int64),
        )

    def load_host_state(self, dpath: str) -> None:
        """Restore the host chains from a ``_driver.npz`` (this driver's or
        the reference driver's: the keys are the same)."""
        z = np.load(dpath)
        if len(z["world_hist"]) or len(z["kf_ids"]):
            raise NotImplementedError(
                f"{dpath} holds refinement history or loop-closure keyframes; pose-graph "
                "refinement and loop closure are not ported yet (ROADMAP A10)")
        self._w_vo64 = z["w_vo64"]
        self._w_lo64 = z["w_lo64"]
        self._w_mo64 = z["w_mo64"]
        self._anchor64 = z["anchor64"] if z["anchor64"].size else None
        self.f32_divergence_m = dict(zip(("vo", "lo", "mo"), (float(v) for v in z["divergence"])))

    def restore_checkpoint(self, path: str) -> int:
        """Restore device + driver state from a checkpoint; truncates the
        trajectory files to the checkpointed row count and re-opens them in
        append mode.  Returns the frame index to resume from."""
        from vloam_tpu_torch.utils.checkpoint import load_checkpoint

        self.state, self.count = load_checkpoint(path, self.state)
        self.load_host_state(path.rstrip("/") + "_driver.npz")
        for w in self.writers.values():
            w.resume_at(self.count)
        return self.count

    def process(self, image: np.ndarray | None, cloud: np.ndarray) -> VloamOutputs:
        cfg = self.cfg
        with self.timer.stage("host_grid"):
            grid, gmask, _ = grid_cloud(cloud.astype(np.float32), cfg.scan)
        return self.process_grid(image, grid, gmask)

    def process_grid(
        self, image: np.ndarray | None, grid: np.ndarray, gmask: np.ndarray
    ) -> VloamOutputs:
        """Feed a pre-built ring grid.  Returns the step's outputs (tensors
        on the device); what the host read of them is ``self.host_out``."""
        cfg, dev = self.cfg, self.device
        if image is None:
            img = np.zeros((cfg.visual.img_height, cfg.visual.img_width), np.float32)
        else:
            img = pad_image(image, cfg)
        grid, gmask = np.asarray(grid), np.asarray(gmask)
        with self.timer.stage("host_buckets"):
            # VO depth buckets built host-side, like the ring gridding
            bu, bv, bz, bc = depth_buckets(grid.reshape(-1, 4), gmask.reshape(-1), self._proj,
                                           cfg.visual)
            buckets = DepthBuckets(*(host_to_device(b, dev) for b in (bu, bv, bz, bc)))
        with self.timer.stage("host_lf_voxel"):
            sg, bs, nr = less_flat_voxel_table(grid, gmask, cfg.scan)
            lf_table = (host_to_device(sg, dev), host_to_device(bs, dev), int(nr))
        with self.timer.stage("vloam_step"):
            self.state, out = vloam_step(
                self.state, host_to_device(img, dev), host_to_device(grid, dev),
                host_to_device(gmask, dev), self.ext, cfg, pre_gridded=True,
                pre_buckets=buckets, pre_lf_table=lf_table,
            )
            self.host_out = host = self._fetch(out)   # waits for the frame
        if cfg.verbose_level >= 1 and self.count > 0:
            # degradation warning (laser_odometry.cpp:493-496: < 10
            # correspondences; the reference proceeds anyway, as do we)
            corr = host.lo_corr
            if int(corr.sum()) < 10:
                print(
                    f"[warn] frame {self.count}: LO degraded — only "
                    f"{int(corr[0])} edge + {int(corr[1])} plane correspondences"
                )
        with self.timer.stage("host_f64_chain"):
            self._accumulate_f64(host)
        if self.writers:
            self.writers["vo"].append(self._export_row(self._w_vo64))
            self.writers["lo"].append(self._export_row(self._w_lo64))
            self.writers["mo"].append(self._export_row(self._w_mo64))
        self.count += 1
        if self.checkpoint_dir and self.checkpoint_every and self.count % self.checkpoint_every == 0:
            self.save_checkpoint()
        return out

    @staticmethod
    def _fetch(out: VloamOutputs) -> VloamOutputs:
        """The outputs the host needs, as NumPy, in ONE device-to-host
        transfer (the frame's only one): the poses of HOST_POSE_FIELDS and
        the LO correspondence counts, stacked.  The trajectory-row fields
        stay on the device and are None here."""
        packed = torch.cat([getattr(out, name) for name in HOST_POSE_FIELDS]
                           + [out.lo_corr.to(torch.float32)]).cpu().numpy()
        n = len(HOST_POSE_FIELDS)
        poses = dict(zip(HOST_POSE_FIELDS, packed[:7 * n].reshape(n, 7)))
        return VloamOutputs(vo_pose=None, lo_pose=None, mo_pose=None,
                            lo_corr=packed[7 * n:].astype(np.int32), **poses)

    def _accumulate_f64(self, out: VloamOutputs) -> None:
        """Rebase this frame's f32 deltas (host values: NumPy arrays or CPU
        tensors) onto the f64 host chains and track the realised divergence
        of the device's f32 chains against them."""
        vo_d = np.asarray(out.vo_delta, np.float64)
        lo_d = np.asarray(out.lo_delta, np.float64)
        mo_c = np.asarray(out.mo_correction, np.float64)
        # mirror the device NaN guard (frame_graph.accumulate_world)
        if np.all(np.isfinite(vo_d)):
            self._w_vo64 = gnp.pose_compose(self._w_vo64, gnp.as_pose64(vo_d))
        if np.all(np.isfinite(lo_d)):
            self._w_lo64 = gnp.pose_compose(self._w_lo64, gnp.as_pose64(lo_d))
        if np.all(np.isfinite(mo_c)):
            # world_MO = wmap_wodom o world_LO exactly (mapping_step)
            self._w_mo64 = gnp.pose_compose(gnp.as_pose64(mo_c), self._w_lo64)
        if self._anchor64 is None:
            b = self._base_T_cam0_64
            self._anchor64 = gnp.pose_compose(
                gnp.pose_compose(gnp.pose_inverse(b), self._w_vo64), b
            )
        for key, w64, w32 in (
            ("vo", self._w_vo64, out.world_vo),
            ("lo", self._w_lo64, out.world_lo),
            ("mo", self._w_mo64, out.world_mo),
        ):
            d = float(np.linalg.norm(np.asarray(w32, np.float64)[4:] - w64[4:]))
            if d > self.f32_divergence_m[key]:
                self.f32_divergence_m[key] = d

    def _export_row(self, world64: np.ndarray) -> np.ndarray:
        """f64 KITTI trajectory row: cam0_start_T_cam0_curr
        (frame_graph.world_to_cam0_start on the host f64 chain)."""
        b = self._base_T_cam0_64
        cam = gnp.pose_compose(gnp.pose_compose(gnp.pose_inverse(b), world64), b)
        return gnp.pose_compose(gnp.pose_inverse(self._anchor64), cam)

    def close(self):
        for w in self.writers.values():
            w.close()


def run_synthetic(
    cfg: VloamConfig,
    n_frames: int = 10,
    speed: float = 0.8,
    yaw_rate: float = 0.005,
    out_dir: str | None = None,
    n_azimuth: int = 900,
    verbose: bool = True,
    lidar_only: bool = False,
    refine: bool = False,
    loop_closure: bool = False,
    device="cuda",
):
    """Full-pipeline run on the synthetic raycast world.  Returns a dict of
    drift metrics vs the exact trajectory (the replacement for the
    reference's saved-rosbag smoke runs)."""
    dev = resolve_device(device)
    ext = fg.kitti_default_extrinsics(dev)
    driver = VloamDriver(cfg, ext, out_dir, refine=refine, loop_closure=loop_closure, device=dev)
    boxes = synthetic.default_scene()
    poses = synthetic.straight_trajectory(n_frames, speed=speed, yaw_rate=yaw_rate)
    K = camera_matrices(ext)[0]

    # world blob texture for the camera (raycast once from the start pose)
    rng = np.random.default_rng(11)
    vc = cfg.visual
    uv0 = np.stack(
        [rng.uniform(20, vc.img_width - 20, 1400), rng.uniform(20, vc.img_height - 20, 1400)], -1
    )
    R_wc0 = poses[0][0] @ synthetic.CAM_R_WORLD.T
    pc0, hit = synthetic.raycast_camera(R_wc0, poses[0][1], boxes, K, uv0)
    blob_world = (pc0[hit] @ R_wc0.T) + poses[0][1]

    t_per_frame = []
    for i, (R, t) in enumerate(poses):
        cloud = synthetic.simulate_scan(R, t, boxes, n_azimuth=n_azimuth, noise=0.005, seed=i)
        if lidar_only:
            img = None
        else:
            R_wc = R @ synthetic.CAM_R_WORLD.T
            img = synthetic.render_blob_image((blob_world - t) @ R_wc, K, vc.img_height, vc.img_width)
        t0 = time.perf_counter()
        driver.process(img, cloud)
        t_per_frame.append(time.perf_counter() - t0)
        if verbose:
            mo = driver.host_out.world_mo[4:]
            print(
                f"frame {i:3d}  {t_per_frame[-1]*1e3:7.1f} ms  "
                f"MO err {np.linalg.norm(mo - t):.3f} m"
            )
    driver.close()

    last = driver.host_out
    gt_final = poses[-1][1]
    path_len = sum(np.linalg.norm(poses[i + 1][1] - poses[i][1]) for i in range(n_frames - 1))
    res = {
        "frames": n_frames,
        "path_len_m": float(path_len),
        "final_err_vo_m": float(np.linalg.norm(last.world_vo[4:] - gt_final)),
        "final_err_lo_m": float(np.linalg.norm(last.world_lo[4:] - gt_final)),
        "final_err_mo_m": float(np.linalg.norm(last.world_mo[4:] - gt_final)),
        "steady_ms_per_frame": float(np.median(t_per_frame[2:]) * 1e3) if n_frames > 2 else None,
        "fps": float(1.0 / np.median(t_per_frame[2:])) if n_frames > 2 else None,
    }
    if verbose:
        print(driver.timer.summary())
        for k, v in res.items():
            print(f"{k}: {v}")
    return res


def run_kitti(
    cfg: VloamConfig,
    sequence,                 # RawSequence | OdometrySequence
    out_dir: str | None = None,
    start: int = 0,
    end: int | None = None,
    verbose: bool = True,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 0,
    resume: str | None = None,
    debug_dir: str | None = None,
    refine: bool = False,
    loop_closure: bool = False,
    device="cuda",
):
    """Run the pipeline over a real KITTI sequence (raw or odometry layout)
    through the NumPy loaders (the ring gridding runs in the loader loop)."""
    dev = resolve_device(device)
    ext = extrinsics_from_calib(sequence.calib, dev)
    driver = VloamDriver(cfg, ext, out_dir,
                         checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                         debug_dir=debug_dir, refine=refine,
                         loop_closure=loop_closure, device=dev)
    if resume:
        start = driver.restore_checkpoint(resume)
    end = len(sequence) if end is None else min(end, len(sequence))
    t_per_frame = []
    for i in range(start, end):
        f = sequence.frame(i)
        grid, gmask, _ = grid_cloud(f.cloud, cfg.scan)
        t0 = time.perf_counter()
        driver.process_grid(f.image, grid, gmask)
        t_per_frame.append(time.perf_counter() - t0)
        if verbose and (i - start) % 50 == 0:
            print(f"frame {i}  {t_per_frame[-1]*1e3:.1f} ms")
    driver.close()
    if verbose:
        print(driver.timer.summary())
    return {
        "frames": end - start,
        "steady_ms_per_frame": float(np.median(t_per_frame[2:]) * 1e3) if len(t_per_frame) > 2 else None,
    }
