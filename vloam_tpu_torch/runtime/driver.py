"""Sequence driver: the frame loop of vloam_main_node.cpp:134-202 (port of
``vloam_tpu/runtime/driver.py``).

Feeds raw clouds and images (or pre-built ring grids) to ``vloam_step`` and
writes the reference's VO{d}.txt / LO{d}.txt / MO{d}.txt trajectory files
({d} = detach_VO_LO as 0/1, vloam_main_node.cpp:99-101), so the reference's
evaluation tooling applies unchanged.

World poses are accumulated twice: in f32 on the device (the coupling
state) and in float64 on the host from the per-frame deltas in VloamOutputs
(geometry_np; the reference leans on Ceres doubles,
laser_odometry.cpp:524-525).  Trajectory export, loop-closure gating and
pose-graph refinement read the f64 chains; the realised f32-vs-f64
divergence is tracked per chain (``f32_divergence_m``).

``close()`` ends a run; with ``refine`` or ``loop_closure`` it first fuses
the three chains in a pose graph (``refine_trajectory``), with loop factors
registered between revisited keyframes when ``loop_closure`` is set, and
writes ``MO{d}_refined.txt``.

Per frame the host reads the device once: the three deltas, the three world
poses and the LO correspondence counts come back as one stacked tensor, and
the host arrays go up through pinned memory without blocking.

``timer`` (``utils/profiling.StageTimer``) times the host stages and the
``vloam_step`` stage, and within it the step's spans: its four layers and
each wait for the card, the fetch's (``wait.fetch``) among them.

Where ``models/graph_step.engages`` holds (a CUDA device; no distortion,
the insert-dedup map), ``process_grid`` replays the steady step from CUDA
graphs (``GraphStep``, ``graph_step`` span) in place of eager
``vloam_step``: the host arrays go up into its fixed buffers, and the state
lives at fixed addresses.

The host stages build the depth buckets and the less-flat table in the
C++ host library (``runtime/native``) when it is available, else in NumPy
(``data/gridding``); ``run_kitti`` reads and grids frames in the library's
prefetcher threads.  ``process`` grids the raw cloud in the library's
threaded float32 gridder, or in NumPy without the library.

With ``debug_dir`` and ``debug_every``, every ``debug_every``-th frame
writes keypoint, optical-flow and lidar-depth PNGs (``dump_debug``): the
detection, the KLT track from the previous dumped frame and the projection
run on the driver's device, the drawing on the host (``utils/visualize``).

The device is ``"cuda"`` unless the caller passes another; a missing GPU
raises.
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
from vloam_tpu_torch.models.graph_step import GraphStep, engages
from vloam_tpu_torch.models.vloam import (VloamOutputs, host_to_device, init_vloam_state,
                                          vloam_step)
from vloam_tpu_torch.ops import image_ops
from vloam_tpu_torch.ops.depth_map import DepthBuckets, project_cloud
from vloam_tpu_torch.ops.scan_registration import extract_features_from_grid
from vloam_tpu_torch.parallel.loop_closure import (detect_revisits, loop_factors,
                                                   register_loop)
from vloam_tpu_torch.parallel.pose_graph import (PoseGraphFactors, concat_factors,
                                                 odometry_factors, optimize_pose_graph_banded)
from vloam_tpu_torch.runtime import native
from vloam_tpu_torch.utils.profiling import StageTimer, span
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
        debug_every: int = 0,
        refine: bool = False,
        loop_closure: bool = False,
        keyframe_every: int = 10,
        loop_radius: float = 6.0,
        loop_min_travel: float = 20.0,
        loop_drift_rate: float = 0.05,
        loop_min_gap: int = 3,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ext = fg.Extrinsics(*(x.to(self.device) for x in ext))
        self.state = init_vloam_state(cfg, self.device)   # the cube map is updated in place
        self._graph = (GraphStep(cfg, self.ext, self.state, self.device)
                       if engages(cfg, self.device) else None)
        self.timer = StageTimer()
        self.count = 0
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.debug_dir = debug_dir
        self.debug_every = debug_every
        self._debug_prev = None      # (image, keypoints, mask) of the last dumped frame
        if debug_dir:
            os.makedirs(debug_dir, exist_ok=True)
        # Pose-graph back end: the per-frame f64 world poses of the three
        # chains, fused after the sequence.
        self.refine = refine or loop_closure
        self._world_hist: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._refined: np.ndarray | None = None
        self._refined_unguarded: np.ndarray | None = None
        self.refine_report: dict = {}
        # Loop closure: every keyframe_every-th frame's ring grid kept on the
        # host, re-registered scan to scan at close() where the MO chain revisits.
        self.loop_closure = loop_closure
        self.keyframe_every = keyframe_every
        self.loop_radius = loop_radius
        self.loop_min_travel = loop_min_travel
        self.loop_drift_rate = loop_drift_rate
        self.loop_min_gap = loop_min_gap
        self._keyframes: dict[int, tuple[np.ndarray, np.ndarray]] = {}
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
        driver state (<path>_driver.npz: the f64 chains, the refinement
        history and the loop-closure keyframes, under the reference driver's
        keys) so a resumed run continues where an uninterrupted one would
        be, refinement and loop closure included."""
        from vloam_tpu_torch.utils.checkpoint import save_checkpoint

        path = os.path.join(self.checkpoint_dir, f"ckpt_{self.count:06d}")
        save_checkpoint(path, self.state, self.count)
        for w in self.writers.values():
            w.flush()
        kf_ids = sorted(self._keyframes)
        arrs = {
            "w_vo64": self._w_vo64, "w_lo64": self._w_lo64, "w_mo64": self._w_mo64,
            "anchor64": (self._anchor64 if self._anchor64 is not None
                         else np.zeros(0, np.float64)),
            "divergence": np.array([self.f32_divergence_m[k] for k in ("vo", "lo", "mo")],
                                   np.float64),
            "world_hist": (np.stack([np.stack(h) for h in self._world_hist])
                           if self._world_hist else np.zeros((0, 3, 7), np.float64)),
            "kf_ids": np.array(kf_ids, np.int64),
        }
        for fid in kf_ids:
            arrs[f"kf_grid_{fid}"], arrs[f"kf_mask_{fid}"] = self._keyframes[fid]
        np.savez(path + "_driver.npz", **arrs)

    def load_host_state(self, dpath: str) -> None:
        """Restore the host state from a ``_driver.npz`` (this driver's or
        the reference driver's: the keys are the same)."""
        z = np.load(dpath)
        self._w_vo64 = z["w_vo64"]
        self._w_lo64 = z["w_lo64"]
        self._w_mo64 = z["w_mo64"]
        self._anchor64 = z["anchor64"] if z["anchor64"].size else None
        self.f32_divergence_m = dict(zip(("vo", "lo", "mo"), (float(v) for v in z["divergence"])))
        wh = z["world_hist"]
        self._world_hist = [(wh[i, 0], wh[i, 1], wh[i, 2]) for i in range(len(wh))]
        self._keyframes = {int(fid): (z[f"kf_grid_{fid}"], z[f"kf_mask_{fid}"])
                           for fid in z["kf_ids"]}

    def restore_checkpoint(self, path: str) -> int:
        """Restore device + driver state from a checkpoint; truncates the
        trajectory files to the checkpointed row count and re-opens them in
        append mode.  Returns the frame index to resume from."""
        from vloam_tpu_torch.utils.checkpoint import load_checkpoint

        state, self.count = load_checkpoint(path, self.state)
        self.state = state if self._graph is None else self._graph.load(state)
        self.load_host_state(path.rstrip("/") + "_driver.npz")
        for w in self.writers.values():
            w.resume_at(self.count)
        return self.count

    def process(self, image: np.ndarray | None, cloud: np.ndarray) -> VloamOutputs:
        """Grid a raw cloud (N, 3) or (N, 4) on the host and feed the grid to
        ``process_grid``.  The grid comes from the library's threaded gridder
        (span ``grid.native``) where the library is available, else from
        NumPy; either way fresh arrays, so a keyframe kept by
        ``process_grid`` is never overwritten by a later frame."""
        cfg = self.cfg
        with self.timer.stage("host_grid"):
            cloud = np.ascontiguousarray(cloud, np.float32)
            if native.available():
                with span("grid.native"):
                    grid, gmask, _ = native.grid_cloud_threaded(cloud, cfg.scan)
            else:
                grid, gmask, _ = grid_cloud(cloud, cfg.scan)
        return self.process_grid(image, grid, gmask)

    def dump_debug(self, image: np.ndarray, grid: np.ndarray, gmask: np.ndarray) -> None:
        """Write keypoint / optical-flow / lidar-depth debug PNGs of the
        CURRENT frame (the reference's visualize_depth /
        visualize_optical_flow rviz topics, visual_odometry.cpp:548-581)
        into debug_dir: ``keypoints_%06d.png``, ``flow_%06d.png`` (the track
        from the previous dumped frame) and ``depth_%06d.png``."""
        from vloam_tpu_torch.utils import visualize as viz

        cfg, dev = self.cfg, self.device
        img = pad_image(image, cfg)
        imt = host_to_device(img, dev)
        kp, kp_mask, _ = image_ops.detect_corners(imt, cfg.visual)
        viz.save_png(os.path.join(self.debug_dir, f"keypoints_{self.count:06d}.png"),
                     viz.draw_keypoints(img, kp.cpu().numpy(), kp_mask.cpu().numpy()))
        if self._debug_prev is not None:
            pimg, pkp, pmask = self._debug_prev
            curr, ok = image_ops.lk_track_fb(host_to_device(pimg, dev), imt, pkp, pmask,
                                             cfg.visual)
            viz.save_png(os.path.join(self.debug_dir, f"flow_{self.count:06d}.png"),
                         viz.draw_flow(img, pkp.cpu().numpy(), curr.cpu().numpy(),
                                       ok.cpu().numpy()))
        proj = self.ext.P_rect0 @ self.ext.R_rect0 @ self.ext.cam_T_velo
        uvz, ok = project_cloud(host_to_device(grid.reshape(-1, 4)[:, :3], dev),
                                host_to_device(gmask.reshape(-1), dev), proj, cfg.visual)
        uvz, ok = uvz.cpu().numpy(), ok.cpu().numpy()
        viz.save_png(os.path.join(self.debug_dir, f"depth_{self.count:06d}.png"),
                     viz.draw_depth(img, uvz[:, :2], uvz[:, 2], ok))
        self._debug_prev = (img, kp, kp_mask)

    def process_grid(
        self, image: np.ndarray | None, grid: np.ndarray, gmask: np.ndarray
    ) -> VloamOutputs:
        """Feed a pre-built ring grid.  Returns the step's outputs (tensors
        on the device); what the host read of them is ``self.host_out``."""
        cfg = self.cfg
        if image is None:
            img = np.zeros((cfg.visual.img_height, cfg.visual.img_width), np.float32)
        else:
            img = pad_image(image, cfg)
        grid, gmask = np.asarray(grid), np.asarray(gmask)
        if self.debug_dir and self.debug_every and self.count % self.debug_every == 0:
            self.dump_debug(img, grid, gmask)
        if self.loop_closure and self.count % self.keyframe_every == 0:
            self._keyframes[self.count] = (grid, gmask)
        use_native = native.available()
        up = self._upload
        with self.timer.stage("host_buckets"):
            # VO depth buckets built host-side, like the ring gridding
            make = native.depth_buckets_native if use_native else depth_buckets
            bu, bv, bz, bc = make(grid.reshape(-1, 4), gmask.reshape(-1), self._proj, cfg.visual)
            buckets = DepthBuckets(*(up(f"buckets.{i}", b) for i, b in enumerate((bu, bv, bz, bc))))
        with self.timer.stage("host_lf_voxel"):
            make = native.lf_voxel_table_native if use_native else less_flat_voxel_table
            sg, bs, nr = make(grid, gmask, cfg.scan)
            # the run count goes up as a tensor: a number would be a constant of a graph
            lf_table = (up("lf_table.slots", sg), up("lf_table.sums", bs),
                        up("lf_table.runs", np.int64(nr)))
        with self.timer.stage("vloam_step"):
            img_t, grid_t, gmask_t = up("image", img), up("grid", grid), up("gmask", gmask)
            if self._graph is None:
                self.state, out = vloam_step(self.state, img_t, grid_t, gmask_t, self.ext, cfg,
                                             pre_gridded=True, pre_buckets=buckets,
                                             pre_lf_table=lf_table)
            else:
                self.state, out = self._graph.step(img_t, grid_t, gmask_t, buckets, lf_table)
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
        if self.refine:
            self._world_hist.append(
                (self._w_vo64.copy(), self._w_lo64.copy(), self._w_mo64.copy()))
        self.count += 1
        if self.checkpoint_dir and self.checkpoint_every and self.count % self.checkpoint_every == 0:
            self.save_checkpoint()
        return out

    def _upload(self, name: str, x: np.ndarray) -> torch.Tensor:
        """A host array of the frame on the device: into the graph step's
        buffer ``name``, or as a tensor of its own."""
        if self._graph is None:
            return host_to_device(x, self.device)
        return self._graph.upload(name, x)

    @staticmethod
    def _fetch(out: VloamOutputs) -> VloamOutputs:
        """The outputs the host needs, as NumPy, in ONE device-to-host
        transfer (the frame's only one): the poses of HOST_POSE_FIELDS and
        the LO correspondence counts, stacked.  The trajectory-row fields
        stay on the device and are None here."""
        packed = torch.cat([getattr(out, name) for name in HOST_POSE_FIELDS]
                           + [out.lo_corr.to(torch.float32)])
        with span("wait.fetch"):
            packed = packed.cpu()
        packed = packed.numpy()
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

    def _keyframe_features(self, fid: int):
        """Scan features of keyframe ``fid`` from its stored ring grid, with
        the device-side less-flat reduction (no host table), as the
        reference extracts them."""
        grid, gmask = self._keyframes[fid]
        g = torch.as_tensor(grid, device=self.device)
        m = torch.as_tensor(gmask, device=self.device)
        return extract_features_from_grid(g, m, m.sum(dim=1).to(torch.int32), self.cfg.scan)

    def _loop_factors(self, mo: np.ndarray):
        """Detect and register loop closures over the stored keyframes.

        Revisits are gated on the MO chain's keyframe positions (real
        traveled path between them, a radius that widens with it); accepted
        registrations (``parallel/loop_closure.register_loop``) become
        relative-pose factors indexed into the full frame graph, weighted by
        their evidence."""
        kf_ids = [i for i in sorted(self._keyframes) if i < len(mo)]
        if len(kf_ids) < 2:
            return None
        positions = np.stack([mo[i][4:] for i in kf_ids])
        pairs_kf = detect_revisits(
            positions, min_gap=self.loop_min_gap, radius=self.loop_radius,
            min_spacing=2, min_travel=self.loop_min_travel,
            drift_rate=self.loop_drift_rate,
        )
        if not pairs_kf:
            return None

        feat_cache: dict[int, object] = {}

        def feats_of(fid):
            if fid not in feat_cache:
                feat_cache[fid] = self._keyframe_features(fid)
            return feat_cache[fid]

        accepted_pairs, zs, corrs = [], [], []
        for jk, kk in pairs_kf:
            fj, fk = kf_ids[jk], kf_ids[kk]
            mo_j, mo_k = (torch.tensor(mo[f], dtype=torch.float32, device=self.device)
                          for f in (fj, fk))
            rel_init = geo.pose_compose(geo.pose_inverse(mo_j), mo_k)
            z, n_tight, ok = register_loop(feats_of(fj), feats_of(fk), rel_init, self.cfg)
            if self.cfg.verbose_level >= 1:
                print(f"[loop] frames ({fj},{fk}): tight_inliers={n_tight} accepted={ok}")
            if ok:
                accepted_pairs.append((fj, fk))
                zs.append(z)
                corrs.append(n_tight)
        if not accepted_pairs:
            return None
        # evidence weighting: information scales with the registration's
        # tight-inlier count (residual weight enters JtJ squared, hence
        # sqrt); normalised so a 600-inlier registration keeps weight 5.0
        w = 5.0 * np.sqrt(np.asarray(corrs, np.float64) / 600.0)
        return loop_factors(accepted_pairs, zs, weight=w, device=self.device)

    @staticmethod
    def _loop_resid_m(chain: np.ndarray, lf) -> float:
        """Mean translation residual (m) of loop factors evaluated on a
        chain: || (inv(chain[i]) o chain[j]).t - z.t || averaged."""
        i, j, z = (np.asarray(x.cpu()) for x in (lf.i, lf.j, lf.z))
        errs = [
            np.linalg.norm(gnp.pose_compose(gnp.pose_inverse(gnp.as_pose64(chain[a])),
                                            gnp.as_pose64(chain[b]))[4:] - z[k][4:])
            for k, (a, b) in enumerate(zip(i, j))
        ]
        return float(np.mean(errs))

    def refine_trajectory(
        self, w_mo: float = 1.0, w_lo: float = 0.2, w_vo: float = 0.05, iters: int = 8
    ) -> np.ndarray | None:
        """Pose-graph fusion over the whole sequence: the VO / LO / MO
        frame-to-frame motions carry partly independent noise, so a
        relative-pose graph with the MO chain dominant smooths the
        trajectory; loop factors (``loop_closure=True``) pull revisits
        together.  Returns the refined (W, 7) world poses (float32) and
        writes ``MO{d}_refined.txt`` when exporting.

        Runs on the host-collected poses (``refine=True`` at construction),
        on the driver's device.  The graph is a chain (up to 3 odometry
        chains over the same poses) plus a few loop factors, so the solve is
        the banded one (block-Thomas plus Woodbury, O(W) an iteration).
        With two or more loop factors a held-out check guards the interior:
        refine with each half of the factors, and if the held-out half's
        residuals come out worse than on the raw chain, keep the raw chain
        (``refine_report["fallback"]``)."""
        if self._refined is not None:
            return self._refined
        if len(self._world_hist) < 3:
            return None
        dev = self.device
        hist = np.stack([np.stack(h) for h in self._world_hist])   # (W, 3, 7) f64
        vo, lo, mo = hist[:, 0], hist[:, 1], hist[:, 2]

        def chain_deltas(p):
            # deltas in f64 on the host (positions are km-scale; an f32
            # inverse-compose there loses ~1e-4 m a link), then f32: the
            # deltas themselves are frame-scale
            d = [gnp.pose_compose(gnp.pose_inverse(p[i]), p[i + 1]) for i in range(len(p) - 1)]
            return torch.tensor(np.stack(d), dtype=torch.float32, device=dev)

        def chain_path(p):
            return float(np.sum(np.linalg.norm(np.diff(p[:, 4:], axis=0), axis=1)))

        # lidar-only runs leave the VO chain at identity; fusing a zero-motion
        # chain would shrink every fused delta, so chains that did not run
        # are left out
        mo_path = chain_path(mo)
        parts = [odometry_factors(chain_deltas(mo), weight=w_mo)]
        if chain_path(lo) > 0.05 * mo_path:
            parts.append(odometry_factors(chain_deltas(lo), weight=w_lo))
        if chain_path(vo) > 0.05 * mo_path:
            parts.append(odometry_factors(chain_deltas(vo), weight=w_vo))
        chain = concat_factors(*parts)
        lf = self._loop_factors(mo) if self._keyframes else None
        mo32 = torch.tensor(mo, dtype=torch.float32, device=dev)

        def solve(loop):
            return optimize_pose_graph_banded(mo32, chain, loop, iters=iters).cpu().numpy()

        refined = solve(lf)
        self.refine_report = {"loop_factors": 0, "fallback": False}
        if lf is not None:
            L = int(lf.i.shape[0])
            self.refine_report["loop_factors"] = L
            self.refine_report["loop_resid_raw_m"] = self._loop_resid_m(mo, lf)
            self.refine_report["loop_resid_refined_m"] = self._loop_resid_m(refined, lf)
            if L >= 2:
                def subset(parity):
                    sel = torch.arange(L, device=dev) % 2 == parity
                    return PoseGraphFactors(*[f[sel] for f in lf])

                even, odd = subset(0), subset(1)
                ref_e, ref_o = solve(even), solve(odd)
                held_raw = 0.5 * (self._loop_resid_m(mo, odd) + self._loop_resid_m(mo, even))
                held_ref = 0.5 * (self._loop_resid_m(ref_e, odd) + self._loop_resid_m(ref_o, even))
                self.refine_report["heldout_raw_m"] = held_raw
                self.refine_report["heldout_refined_m"] = held_ref
                if held_ref > held_raw:
                    self.refine_report["fallback"] = True
                    if self.cfg.verbose_level >= 1:
                        print(f"[loop] guard: held-out loop residual worsened "
                              f"({held_raw:.2f} -> {held_ref:.2f} m); keeping the raw chain")
                    self._refined_unguarded = refined   # kept for diagnostics
                    refined = np.asarray(mo, np.float32).copy()

        if self.out_dir is not None:
            d = int(self.cfg.detach_vo_lo)
            w = TrajectoryWriter(os.path.join(self.out_dir, f"MO{d}_refined.txt"))
            for p in refined:
                w.append(self._export_row(gnp.as_pose64(p)))
            w.close()
        self._refined = refined
        return refined

    def close(self):
        if self._graph is not None:
            self._graph.close()
        if self.refine:
            self.refine_trajectory()
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
    keyframe_every: int = 10,
    loop_kw: dict | None = None,
    debug_dir: str | None = None,
    debug_every: int = 0,
    device="cuda",
):
    """Full-pipeline run on the synthetic raycast world.  Returns a dict of
    drift metrics vs the exact trajectory (the replacement for the
    reference's saved-rosbag smoke runs); with ``refine`` also the refined
    trajectory's final error (``final_err_refined_m``).  ``debug_dir`` /
    ``debug_every`` dump debug PNGs as in ``run_kitti`` (the reference's
    ``run_synthetic`` has no such options)."""
    dev = resolve_device(device)
    ext = fg.kitti_default_extrinsics(dev)
    driver = VloamDriver(cfg, ext, out_dir, debug_dir=debug_dir, debug_every=debug_every,
                         refine=refine, loop_closure=loop_closure,
                         keyframe_every=keyframe_every, device=dev, **(loop_kw or {}))
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
    if refine and len(driver._world_hist) >= 3:
        refined = driver.refine_trajectory()
        if refined is not None:
            res["final_err_refined_m"] = float(np.linalg.norm(refined[-1][4:] - gt_final))
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
    debug_every: int = 0,
    refine: bool = False,
    loop_closure: bool = False,
    keyframe_every: int = 10,
    loop_kw: dict | None = None,
    device="cuda",
):
    """Run the pipeline over a real KITTI sequence (raw or odometry layout).

    With the native host library the frames come from its prefetcher, whose
    threads read, decode and grid them while the device works; without it
    from the NumPy loaders, gridded in the loop."""
    dev = resolve_device(device)
    ext = extrinsics_from_calib(sequence.calib, dev)
    driver = VloamDriver(cfg, ext, out_dir,
                         checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                         debug_dir=debug_dir, debug_every=debug_every, refine=refine,
                         loop_closure=loop_closure,
                         keyframe_every=keyframe_every, device=dev, **(loop_kw or {}))
    if resume:
        start = driver.restore_checkpoint(resume)
    end = len(sequence) if end is None else min(end, len(sequence))
    t_per_frame = []

    def frames():
        """Yields (image, grid, gmask)."""
        if native.available():
            names = sequence.files[start:end]
            bins = [os.path.join(sequence.velo_dir, f) for f in names]
            imgs = ([os.path.join(sequence.img_dir, os.path.splitext(f)[0] + ".png")
                     for f in names] if sequence.with_images else None)
            with native.NativePrefetcher(bins, imgs, cfg.scan.max_points, cfg.visual.img_height,
                                         cfg.visual.img_width, scan_cfg=cfg.scan) as pf:
                for grid, gmask, _, img in pf.iter_grids():
                    yield img, grid, gmask
        else:
            for i in range(start, end):
                f = sequence.frame(i)
                grid, gmask, _ = grid_cloud(f.cloud, cfg.scan)
                yield f.image, grid, gmask

    for i, (img, grid, gmask) in enumerate(frames(), start):
        t0 = time.perf_counter()
        driver.process_grid(img, grid, gmask)
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
