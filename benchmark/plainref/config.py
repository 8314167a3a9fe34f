"""Configuration for the whole engine.

Surfaces every runtime flag of the reference (SURVEY.md §5.6 inventory:
src/vloam_main/launch/vloam_main.launch:4-16,
loam_velodyne_HDL_64_kitti.launch:3-16) *plus* the numeric knobs the
reference hard-codes, *plus* the fixed-shape capacities that a jit-once
TPU design needs (the reference used unbounded std::vectors).

Everything is a frozen dataclass so configs hash and can be closed over by
jitted step functions as static arguments.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ScanConfig:
    """Lidar scan geometry + feature extraction (scan_registration.cpp)."""

    n_scans: int = 64                 # scan_line param (16/32/64)
    minimum_range: float = 5.0        # minimum_range param
    scan_period: float = 0.1          # scanPeriod (scan_registration.cpp:294-297)
    # fixed-shape ring grid: points per ring after azimuth binning
    ring_cap: int = 2048              # HDL-64 fires ~2170/rev; KITTI clouds have <=~2000/ring
    max_points: int = 131072          # padded raw cloud capacity (~120k for KITTI)
    n_sectors: int = 6                # per-ring sectors (scan_registration.cpp:358-361)
    curvature_window: int = 5         # +-5 neighbours (scan_registration.cpp:323-346)
    edge_threshold: float = 0.1       # curvature > 0.1 => edge (scan_registration.cpp:381)
    surf_threshold: float = 0.1       # curvature < 0.1 => planar (scan_registration.cpp:443)
    max_sharp: int = 2                # per sector (scan_registration.cpp:386-391)
    max_less_sharp: int = 20          # per sector (scan_registration.cpp:392-395)
    max_flat: int = 4                 # per sector (scan_registration.cpp:449-454)
    neighbor_suppression: int = 5     # +-5 point suppression (scan_registration.cpp:406-429)
    suppression_gap_sq: float = 0.05  # gap^2 that breaks suppression (scan_registration.cpp:411)
    less_flat_voxel: float = 0.2      # leaf size (scan_registration.cpp:500)
    less_flat_cap: int = 32768        # padded size of downsampled less-flat cloud
    exclude_unreliable: bool = False  # original-LOAM occluded/parallel-beam
                                      # point exclusion (loam_velodyne
                                      # scanRegistration.cpp; the A-LOAM-derived
                                      # reference DROPPED it, scan_registration
                                      # .cpp:381 picks with no such mask — off by
                                      # default for parity).  Turning it on
                                      # removes sensor-relative false edges
                                      # (occlusion silhouettes, grazing arcs):
                                      # on the 300-frame validation drive it
                                      # improves MO accuracy 5.2x (0.626% ->
                                      # 0.121% trans, ATE 2.12 -> 0.13 m) at
                                      # identical fps (VALIDATION_r04
                                      # excl_decoupled_D; synthetic-world
                                      # measurement — raycast worlds have
                                      # sharper silhouettes than real lidar).
                                      # Recommended ON for deployment.


@dataclass(frozen=True)
class OdometryConfig:
    """Scan-to-scan LO (laser_odometry.cpp)."""

    distance_sq_threshold: float = 25.0  # laser_odometry.h:94
    nearby_scan: float = 2.5             # laser_odometry.h:95
    assoc_k: int = 8                     # k-NN pool the ring-constrained EDGE
                                         # picks are resolved from (ours; the
                                         # ref's kd-tree scans have no such
                                         # bound).  Oracle-measured pair
                                         # recall vs laser_odometry.cpp:282-383
                                         # at k=8: 0.993 (test_oracle_parity).
    assoc_k_surf: int = 16               # plane triples need a deeper pool:
                                         # the same-ring neighbours of a flat
                                         # point crowd out the other-ring
                                         # slot3 pick.  Oracle-measured triple
                                         # recall: 0.84 @ k=8, 0.95 @ 16,
                                         # 0.996 @ 32 (test_oracle_parity);
                                         # fps 108.3 / 108.0 / 103.1.  Missing
                                         # triples only thin an overdetermined
                                         # fit (pose gap ~4 mm even @ k=8);
                                         # 16 is the knee of that curve.
    outer_iters: int = 2                 # laser_odometry.cpp:224
    inner_iters: int = 4                 # ceres max_num_iterations (laser_odometry.cpp:503)
    huber_delta: float = 0.1             # HuberLoss(0.1) (laser_odometry.cpp:230)
    distortion: bool = False             # DISTORTION=false for KITTI (laser_odometry.h:90)
    lm_lambda: float = 1e-4              # LM damping for the 6x6 solve (Ceres-equivalent trust region)


@dataclass(frozen=True)
class MappingConfig:
    """Scan-to-map MO (laser_mapping.cpp)."""

    cube_size: float = 50.0           # laser_mapping.h:113-122
    grid_w: int = 21                  # cubes along x
    grid_h: int = 21                  # cubes along y
    grid_d: int = 11                  # cubes along z
    submap_rx: int = 2                # +-2 cubes in x,y (laser_mapping.cpp:448-452)
    submap_rz: int = 1                # +-1 cubes in z
    line_resolution: float = 0.4      # mapping_line_resolution (KITTI launch)
    plane_resolution: float = 0.8     # mapping_plane_resolution
    corner_cube_cap: int = 2048       # fixed per-cube corner point capacity (design choice; ref unbounded)
    surf_cube_cap: int = 4096         # fixed per-cube surf point capacity
    corner_stack_cap: int = 4096      # downsampled input corner features per frame
    surf_stack_cap: int = 8192        # downsampled input surf features per frame
    submap_corner_cap: int = 16384    # gathered submap corner points (75 cubes);
                                      # A-LOAM corner maps on KITTI run ~5-15k after
                                      # the 0.4m voxel filter — 16k is ~2x headroom
    submap_surf_cap: int = 49152      # gathered submap surf points (~20-40k typical
                                      # at 0.8m resolution; 384*128 stays MXU-tiled)
    n_neighbors: int = 5              # 5-NN PCA/plane fits (laser_mapping.cpp:554,633)
    neighbor_dist_sq: float = 1.0     # pointSearchSqDis[4] < 1.0 gate (laser_mapping.cpp:557,642)
    eigen_ratio: float = 3.0          # lambda2 > 3*lambda1 line validity (laser_mapping.cpp:591)
    plane_fit_tol: float = 0.2        # |n.p + d| <= 0.2 plane validity (laser_mapping.cpp:667)
    line_span: float = 0.1            # virtual points at +-0.1m (laser_mapping.cpp:596-597)
    outer_iters: int = 2              # laser_mapping.cpp:526
    inner_iters: int = 4              # ceres max_num_iterations (laser_mapping.cpp:712)
    huber_delta: float = 0.1          # laser_mapping.cpp:529
    lm_lambda: float = 1e-4
    min_map_corner: int = 10          # laserCloudCornerFromMapNum > 10 gate (laser_mapping.cpp:514)
    min_map_surf: int = 50            # laserCloudSurfFromMapNum > 50 gate
    skip_frame: int = 1               # mapping_skip_frame
    insert_dedup: bool = True         # ours: gate insertions on nearest-map-point
                                      # distance instead of re-voxelising the 75
                                      # window cubes every frame (laser_mapping.cpp:793-808)
                                      # — same bounded density, ~30x cheaper on TPU
    insert_dedup_factor: float = 0.5  # gate radius = factor * voxel resolution


@dataclass(frozen=True)
class VisualConfig:
    """VO frontend + solver (visual_odometry.cpp, image_util.cpp, point_cloud_util.cpp)."""

    img_height: int = 376             # padded KITTI gray left (raw 375/376 x 1241/1242)
    img_width: int = 1248             # padded to a lane-friendly multiple of 8
    # Detector (image_util.h DetectorType): the full reference enum is
    # available through vloam_tpu.image_util.det_keypoints —
    # shitomasi | brisk | fast | orb | akaze | sift (ops/{image_ops,brisk,
    # akaze,sift}.py).  The hot VO step dispatches shitomasi/fast inline.
    detector_type: str = "shitomasi"
    fast_threshold: float = 20.0      # FAST-9/16 intensity threshold
    # Shi-Tomasi (image_util.cpp:16-58)
    block_size: int = 5
    min_distance: float = 7.5         # 1.5 * block_size
    max_corners: int = 1024
    quality_level: float = 0.03
    # Descriptor + matcher (image_util.h DescriptorType/MatcherType/SelectType):
    # full enum via vloam_tpu.image_util — descriptors brisk | orb | brief |
    # akaze | freak | sift; the VO step dispatches orb/brief inline.
    descriptor_type: str = "orb"
    matcher_type: str = "bf"          # "bf" (exact) | "flann" (approx prefilter + rerank)
    match_select: str = "knn"         # "knn" (2-NN + 0.8 ratio) | "nn" (cross-check)
    match_ratio: float = 0.8          # Lowe ratio (image_util.cpp:417)
    # bucketed NMS (image_util.cpp:202-261)
    keypoint_nms: bool = False
    nms_bucket_width: int = 100
    nms_bucket_height: int = 100
    nms_max_total: int = 400
    # CLAHE (visual_odometry.cpp:110-114)
    clahe: bool = False
    clahe_clip: float = 2.0
    # KLT (image_util.cpp:526,562-570)
    optical_flow_match: bool = True   # our default frontend: pyramidal LK (TPU-friendly)
    klt_window: int = 15
    klt_levels: int = 2               # maxLevel=2 => 3 pyramid levels in OpenCV terms;
                                      # needed for prior-less frames (sequence start)
    klt_iters: int = 10
    klt_eps: float = 0.03
    klt_min_eig: float = 1e-4
    klt_fb_check: bool = True         # forward-backward track validation (ours; ref has none)
    klt_fb_iters: int = 4             # backward-pass GN iterations: the check
                                      # STARTS at the expected return point
                                      # (fb_err = drift from it), so it only
                                      # confirms/refutes — 4 iters suffice
                                      # where the forward solve needs 10
    klt_fb_threshold: float = 1.0     # max forward-backward return error (px)
    klt_max_err: float = 12.0         # max mean |I1-I0| over the converged window
                                      # (photometric gate; catches textureless windows
                                      # the seeded backward pass cannot)
    klt_patch_slack: int = 8          # extra patch margin so per-level iterations
                                      # stay inside one contiguous slice; 8 makes the
                                      # patch 2*(7+8+1)=32 px — lane-aligned on TPU
                                      # (slack 4 measurably degrades prior-less
                                      # tracking: the coarse-level upsample error
                                      # clips against the patch)
    # depth buckets (point_cloud_util.cpp:34,256-487)
    downsample_grid: int = 5
    query_radius: int = 2
    min_depth_neighbors: int = 10
    depth_knn: int = 3
    min_projection_depth: float = 0.1
    depth_spread_gate: float = 1.0    # reject queries whose 3-NN depths spread wider (m);
                                      # the reference sketches this gate but leaves it
                                      # disabled (point_cloud_util.cpp:449-460); <=0 disables
    # solver (visual_odometry.cpp:304-509)
    remove_vo_outlier: float = 100.0  # pixel displacement gate
    reset_vo_to_identity: bool = False
    huber_delta: float = 0.1
    max_iters: int = 10               # ceres used <=100; GN converges in far fewer
    lm_lambda: float = 1e-4
    max_features: int = 1024          # fixed feature buffer size


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout for distributed mapping / BA (beyond the reference)."""

    map_axis: str = "map"             # mesh axis the submap/normal-eq reduction shards over
    map_shards: int = 1               # number of devices along the map axis


@dataclass(frozen=True)
class VloamConfig:
    """Top-level run configuration (vloam_main launch equivalents)."""

    scan: ScanConfig = ScanConfig()
    odom: OdometryConfig = OdometryConfig()
    mapping: MappingConfig = MappingConfig()
    visual: VisualConfig = VisualConfig()
    parallel: ParallelConfig = ParallelConfig()

    detach_vo_lo: bool = True         # detach_VO_LO: true => decoupled "(D)" mode (vloam_main.launch:4)
    save_traj: bool = True
    verbose_level: int = 1            # loam_verbose_level

    def replace(self, **kw) -> "VloamConfig":
        return dataclasses.replace(self, **kw)


def kitti_hdl64() -> VloamConfig:
    """The configuration matching loam_velodyne_HDL_64_kitti.launch."""
    return VloamConfig()


def vlp16() -> VloamConfig:
    """loam_velodyne_VLP_16.launch: 16-beam, finer map resolutions."""
    return VloamConfig(
        scan=ScanConfig(n_scans=16, minimum_range=0.3, ring_cap=2048),
        mapping=MappingConfig(line_resolution=0.2, plane_resolution=0.4),
    )


def hdl32() -> VloamConfig:
    """loam_velodyne_HDL_32.launch."""
    return VloamConfig(
        scan=ScanConfig(n_scans=32, minimum_range=0.3, ring_cap=2048),
        mapping=MappingConfig(line_resolution=0.4, plane_resolution=0.8),
    )
