"""The port's SIFT front end against the benchmark's plain reference
(``benchmark/plainref/ops/sift.py``), on the CPU: what the ``sift.street1``
cell's ``correct`` rests on.

* ``detect``, ``orient``, ``describe`` and ``match_float_descriptors`` (both
  selects) of ``vloam_tpu_torch/ops/sift`` against the reference's on seeded
  blob images of 192 x 320 with a budget of 256.  Bound: equal bit for bit,
  since both run the same torch ops in the same order on the CPU (the
  reference cuts its windows with the plain gather, as the port's CPU path
  does).  192 rows is the least that works: the fourth octave (1/8 scale)
  must hold a 24-pixel window.
* A 6-frame seeded drive of the cell's traffic through the port's
  ``VloamDriver`` (eager on the CPU) against the reference's
  ``PlainDriver`` under the cell's configuration, cut to a 376 x 640 image
  (KITTI's rows and the columns up to past the principal point at u = 607,
  so the lidar gives the keypoints depth) with a budget of 256, and a lidar
  of 300 azimuths with small caps.  Bound: every exported VO, LO and MO
  position within 1e-5 m (a float32 rounding of the ~5 m the drive covers
  is 5e-7 m); the CPU paths run the same ops, so the gaps read 0 here.
* The comparison fails with a fault planted in the port's SIFT: ``orient``
  returning angle 0, and the 0.8 ratio test left out of the matcher; both
  the ops' comparison and VO's positions over the drive's first two frames
  (frame 1 is VO's first solve).

Torch runs one thread here: the small ops of these drives run ~15x slower
when several workers' thread pools share the host's cores.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from plainref.ops import sift as rsift  # noqa: E402
from vloam_tpu_torch.ops import sift as psift  # noqa: E402

H, W = 192, 320            # the ops' images
DRIVE_H, DRIVE_W = 376, 640
N_KP = 256
N_FRAMES = 6
N_AZIMUTH = 300
DRIVE_SEED = 2**31 + 2301
POS_TOL = 1e-5   # metres
SMALL_SCAN = dict(ring_cap=512, max_points=32768, less_flat_cap=2048)
SMALL_MAP = dict(grid_w=5, grid_h=5, grid_d=3, corner_cube_cap=512, surf_cube_cap=1024,
                 corner_stack_cap=1024, surf_stack_cap=2048, submap_corner_cap=1024,
                 submap_surf_cap=2048)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def blobs(seed: int, shift=(0, 0)) -> torch.Tensor:
    """A (H, W) grey image in [0, 255]: 80 Gaussian blobs of random size and
    brightness, shifted by ``shift`` (rows, columns) pixels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.full((H, W), 40.0)
    for _ in range(80):
        cy, cx = rng.uniform(0, H) + shift[0], rng.uniform(0, W) + shift[1]
        s, a = rng.uniform(1.5, 5.0), rng.uniform(60.0, 200.0)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return torch.tensor(np.clip(img, 0.0, 255.0), dtype=torch.float32)


def op_mismatches(seed: int) -> list:
    """The port's SIFT ops against the reference's on one image pair (the
    second shifted by (2, 5) pixels): the names of the results that differ."""
    img0, img1 = blobs(seed), blobs(seed, (2, 5))
    bad = []

    def features(mod, img):
        kp = mod.detect(img, N_KP)
        octs = mod.gaussian_octaves(img)
        okp = mod.orient(octs, kp)
        desc, valid = mod.describe(octs, okp)
        return kp, okp, desc, valid

    port = [features(psift, img) for img in (img0, img1)]
    ref = [features(rsift, img) for img in (img0, img1)]
    for (pk, po, pd, pv), (rk, ro, rd, rv) in zip(port, ref):
        for name in rsift.SiftKeypoints._fields:
            if not torch.equal(getattr(pk, name), getattr(rk, name)):
                bad.append(f"detect.{name}")
        if not torch.equal(po.angle, ro.angle):
            bad.append("orient.angle")
        if not (torch.equal(pd, rd) and torch.equal(pv, rv)):
            bad.append("describe")
    (_, _, d0, v0), (_, _, d1, v1) = ref
    assert int(v0.sum()) >= 50 and int(v1.sum()) >= 50
    for select in ("knn", "nn"):
        got = psift.match_float_descriptors(d0, v0, d1, v1, 0.8, select)
        want = rsift.match_float_descriptors(d0, v0, d1, v1, 0.8, select)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            bad.append(f"match.{select}")
        assert int(want[1].sum()) >= 30
    return sorted(set(bad))


def cell_drive():
    """The cell's configuration at the small sizes, for the port and for the
    reference, and the first frames of its traffic."""
    from plainref import config as rconfig
    from plainref.models import frame_graph as rfg
    from vbench import spec, traffic
    from vloam_tpu_torch import config as pconfig
    cell = spec.load_cell(ROOT, "sift.street1")
    fields = copy.deepcopy(cell.config["vloam"])
    fields["scan"].update(SMALL_SCAN)
    fields["mapping"].update(SMALL_MAP)
    fields["visual"].update(img_height=DRIVE_H, img_width=DRIVE_W, max_corners=N_KP)
    fields["verbose_level"] = 0
    tr = copy.deepcopy(cell.traffic)
    tr["lidar"]["n_azimuth"] = N_AZIMUTH
    K = rfg.kitti_default_extrinsics("cpu").P_rect0[:, :3].numpy().astype(np.float64)
    frames, _ = traffic.make_drive(tr, DRIVE_H, DRIVE_W, K, DRIVE_SEED, 0, "cpu",
                                   n_frames=N_FRAMES)
    return spec.build_config(pconfig, fields), spec.build_config(rconfig, fields), frames


@pytest.fixture(scope="module")
def drive():
    """The drive and the reference's exported rows {chain: (n, 7) poses}."""
    from plainref.driver import PlainDriver
    pcfg, rcfg, frames = cell_drive()
    ref = PlainDriver(rcfg, "cpu")
    for img, cloud in frames:
        ref.process(img, cloud)
    return pcfg, frames, {c: np.array(r) for c, r in ref.rows.items()}


def port_gaps(pcfg, frames, ref_rows) -> dict:
    """The port's exported positions against the reference's: the largest
    gap (m) a chain over the drive."""
    from vloam_tpu_torch import geometry_np as gnp
    from vloam_tpu_torch.models import frame_graph as fg
    from vloam_tpu_torch.runtime.driver import VloamDriver
    drv = VloamDriver(pcfg, fg.kitti_default_extrinsics("cpu"), device="cpu")
    assert drv._graph is None
    rows = {c: [] for c in ref_rows}
    n = len(frames)
    for img, cloud in frames:
        drv.process(img, cloud)
        for c, w in (("vo", drv._w_vo64), ("lo", drv._w_lo64), ("mo", drv._w_mo64)):
            rows[c].append(drv._export_row(w))
    drv.close()
    gaps = {}
    for c, want in ref_rows.items():
        got, want = np.array(rows[c]), want[:n]
        t_got = np.array([gnp.pose_to_matrix(r)[:3, 3] for r in got])
        t_want = np.array([gnp.pose_to_matrix(r)[:3, 3] for r in want])
        gaps[c] = float(np.abs(t_got - t_want).max())
    return gaps


def angle_zero(real):
    def orient(octs, kp):
        return real(octs, kp)._replace(angle=torch.zeros_like(kp.angle))
    return orient


def no_ratio(real):
    def match(desc0, mask0, desc1, mask1, ratio=0.8, select="knn"):
        # any second neighbour passes: the ratio test left out
        return real(desc0, mask0, desc1, mask1, 1e4, select)
    return match


FAULTS = {"orient_angle_zero": ("orient", angle_zero),
          "ratio_test_left_out": ("match_float_descriptors", no_ratio)}


@pytest.mark.parametrize("seed", [0, 1])
def test_ops_equal_the_plain_reference(seed):
    assert op_mismatches(seed) == []


def test_drive_equals_the_plain_reference(drive):
    pcfg, frames, ref_rows = drive
    assert pcfg.visual.detector_type == pcfg.visual.descriptor_type == "sift"
    gaps = port_gaps(pcfg, frames, ref_rows)
    assert all(g <= POS_TOL for g in gaps.values()), gaps
    # the drive moves: VO's last position lies metres from its first
    from plainref import geometry_np as rgnp
    assert np.linalg.norm(rgnp.pose_to_matrix(ref_rows["vo"][-1])[:3, 3]) > 2.0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_comparison(fault, drive, monkeypatch):
    name, plant = FAULTS[fault]
    monkeypatch.setattr(psift, name, plant(getattr(psift, name)))
    assert op_mismatches(0) != []
    pcfg, frames, ref_rows = drive
    gaps = port_gaps(pcfg, frames[:2], ref_rows)
    print(fault, gaps)
    assert gaps["vo"] > POS_TOL, gaps


def test_plain_sift_imports_nothing_of_the_program():
    import ast
    src = open(os.path.join(BENCH, "plainref", "ops", "sift.py")).read()
    mods = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split(".")[0])
    assert mods <= {"__future__", "functools", "math", "typing", "numpy", "torch", "plainref"}
    assert rsift.SiftKeypoints._fields == psift.SiftKeypoints._fields
