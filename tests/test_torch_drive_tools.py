"""The port's system-level drives (``vloam_tpu_torch/tools/loop_drive``,
``coupling_drive``, ``coupling_scenarios``) against the reference package's
``tools/`` of the same names.

* The worlds and the ground truth the tools build equal the reference's:
  ``ring_world`` and ``route_world`` bit for bit, ``gt_delta`` within one
  float32 step of the quaternion, ``pose_err`` exactly.
* Each tool's record arithmetic equals the reference tool's: both tools run
  at their own flags with the same canned driver (``CannedDriver``) and the
  same stubs for the NumPy raycasts and the blob render, in both packages,
  so every number of the record (drift, detection counts under both gates,
  ATE and final errors, KITTI error, the telemetry's turn / straight split
  and medians, the scenarios' progress) comes out of each tool's own code
  on the same chain.  The stubs carry the tools' inputs (pose, world,
  noise, beam count, seed, camera draws) into that chain, so a tool that
  fed the driver other inputs would also show.
* Each tool's CLI runs end to end in a subprocess on the CPU, with the
  64-beam preset shrunk to the runtime CLI test's tiny sizes (the CLIs have
  no size flags, as the reference's have none) and a few frames: it writes
  every key of the reference tool's record under the reference's record
  keys, refuses a ``VALIDATION_r0*.json`` as ``--out``, and loads no jax.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

from types import SimpleNamespace

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import vloam_tpu.data.synthetic as jsyn
import vloam_tpu.runtime.driver as jdriver
import vloam_tpu_torch.runtime.driver as tdriver
from vloam_tpu_torch import geometry_np as gnp
from vloam_tpu_torch.data import synthetic as tsyn
from vloam_tpu_torch.tools import coupling_drive, coupling_scenarios, loop_drive

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_tool(name):
    """The reference package's ``tools/<name>.py`` as a module (its jax
    imports sit inside its functions)."""
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dict_keys(path, where):
    """The keys of the dict literal assigned to ``where`` (e.g. ``result``,
    ``results[mode]``) or, for ``return <fn>``, returned by function fn."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    for node in ast.walk(tree):
        if where.startswith("return ") and isinstance(node, ast.FunctionDef) \
                and node.name == where.split()[1]:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Return) and isinstance(sub.value, ast.Dict):
                    return {k.value for k in sub.value.keys}
        if (isinstance(node, ast.Assign) and ast.unparse(node.targets[0]) == where
                and isinstance(node.value, ast.Dict)):
            return {k.value for k in node.value.keys if k is not None}
    raise AssertionError(f"no dict for {where} in {path}")


@pytest.mark.parametrize("radius", [20.7, 310.4])
def test_ring_world_is_the_reference_copy(radius):
    np.testing.assert_array_equal(loop_drive.ring_world(radius),
                                  reference_tool("loop_drive").ring_world(radius))


def test_route_world_and_ground_truth_are_the_reference_copy():
    ref = reference_tool("coupling_drive")
    poses = tsyn.turns_trajectory(80, speed=1.1, straight=24, turn_frames=9)
    np.testing.assert_array_equal(coupling_drive.route_world(poses),
                                  ref.route_world(poses))
    np.testing.assert_array_equal(coupling_drive.route_world(poses, sparse_every=2,
                                                             sparse_keep=0.5),
                                  ref.route_world(poses, sparse_every=2, sparse_keep=0.5))
    for i in (0, 23, 24, 28, 32, 60):
        got = coupling_drive.gt_delta(*poses[i], *poses[i + 1])
        want = ref.gt_delta(*poses[i], *poses[i + 1])
        np.testing.assert_allclose(got[:4], want[:4], rtol=0, atol=1.2e-7)
        np.testing.assert_array_equal(got[4:], want[4:])
        other = np.array([0.01, -0.02, 0.03, 0.999, 1.1, 0.05, -0.01])
        assert coupling_drive.pose_err(got, other) == ref.pose_err(got, other)


def stub_scan(R, t, boxes, n_azimuth=900, noise=0.02, seed=0, **kw):
    """One row: the pose, then what the tool asked the raycast for."""
    boxes = np.asarray(boxes)
    return np.concatenate([np.asarray(R, np.float64).ravel(), t,
                           [boxes.sum(), len(boxes), noise, n_azimuth, seed]])[None]


def stub_camera(R_wc, t, boxes, K, uv):
    """Hits that depend on the tool's pixel draws, its intrinsics and world."""
    pc = np.column_stack([uv, np.full(len(uv), K[0, 0] * 1e-3 + 1e-6 * np.sum(boxes))])
    return pc, (uv[:, 0] + uv[:, 1]) % 2.0 < 1.0


def stub_image(points_cam, K, height, width, **kw):
    return np.array([[np.sum(points_cam), len(points_cam), K[0, 2], height, width]])


class CannedDriver:
    """Stands in for both packages' ``VloamDriver``.  Its MO chain is the
    true pose, read back from ``stub_scan``'s row, plus a translation and a
    yaw drift that grow with the path and turn with the mode and with the
    scan's and the image's content; the VO chain and the per-frame deltas
    follow from it."""

    def __init__(self, cfg, ext, loop_closure=False, keyframe_every=10, **kw):
        self.angle = 0.7 if cfg.detach_vo_lo else 1.9
        self.every = keyframe_every
        self.i, self.path, self.prev, self.rows = 0, 0.0, None, []
        self._keyframes = {}
        self.refine_report = {"loop_factors": 2, "fell_back": False}
        self.f32_divergence_m = 1.25e-3
        self._refined = self._refined_unguarded = None

    def process(self, img, cloud):
        R, t, asked = cloud[0, :9].reshape(3, 3), cloud[0, 9:12], cloud[0, 12:]
        seen = asked.sum() + (0.0 if img is None else np.sum(img))
        true = np.concatenate([Rotation.from_matrix(R).as_quat(), t])
        if self.prev is not None:
            self.path += float(np.linalg.norm(t - self.prev[0][4:]))
        a = self.angle + 1e-3 * (seen % 1000.0)
        drift = 0.02 * self.path * np.array([np.cos(a), np.sin(a), 0.05])
        yaw = Rotation.from_rotvec([0.0, 0.0, 2e-4 * self.path * np.sin(a)])
        mo = np.concatenate([(Rotation.from_matrix(R) * yaw).as_quat(), t + drift])
        ident = gnp.pose_identity()
        if self.prev is None:
            vo_delta = lo_delta = ident
        else:
            gt = gnp.pose_compose(gnp.pose_inverse(self.prev[0]), true)
            vo_delta = gt + np.array([0, 0, 0, 0, 0.01 * np.sin(self.i * a), 0.002, 0])
            lo_delta = gnp.pose_compose(gnp.pose_inverse(self.prev[1]), mo)
        self._w_mo64 = mo
        self.host_out = SimpleNamespace(world_mo=mo, world_vo=true - np.r_[0, 0, 0, 0, drift / 2],
                                        vo_delta=vo_delta, lo_delta=lo_delta)
        if self.i % self.every == 0:
            self._keyframes[self.i] = None
        self.rows.append((true, drift))
        self.prev = (true, mo)
        self.i += 1
        return self.host_out

    def close(self):
        if self.rows:
            self._refined = np.stack([p + np.r_[0, 0, 0, 0, 0.25 * d] for p, d in self.rows])
            self._refined_unguarded = np.stack([p + np.r_[0, 0, 0, 0, 0.4 * d]
                                                for p, d in self.rows])


@pytest.fixture
def canned(monkeypatch):
    """Both packages' driver and raycasts replaced by the canned ones."""
    for drv in (jdriver, tdriver):
        monkeypatch.setattr(drv, "VloamDriver", CannedDriver)
    for syn in (jsyn, tsyn):
        monkeypatch.setattr(syn, "simulate_scan", stub_scan)
        monkeypatch.setattr(syn, "raycast_camera", stub_camera)
        monkeypatch.setattr(syn, "render_blob_image", stub_image)
    return monkeypatch


def reference_record(canned, name, tmp_path, *args):
    """Run the reference tool's ``main`` on ``args`` (its own ``--out``
    under tmp_path); returns (the file it wrote, its last stdout line)."""
    out = tmp_path / "reference.json"
    canned.setattr(sys, "argv", [name, *args, "--out", str(out)])
    reference_tool(name).main()
    return json.load(open(out))


TIMES = {"drive_s", "close_s", "frame_gen_s", "process_s", "note", "device"}


@pytest.mark.parametrize("laps", [1, 2])
def test_loop_drive_record_equals_the_reference_tools(canned, tmp_path, laps):
    """The reference tool's defaults (1500 frames, 1 or 2 laps): every
    number of the record equal, detections under both gates included."""
    args = ["--laps", str(laps), "--exclude-unreliable"]
    want = reference_record(canned, "loop_drive", tmp_path, *args)["loop_drive"]
    loop_drive.main([*args, "--device", "cpu", "--out", str(tmp_path / "port.json")])
    got = json.load(open(tmp_path / "port.json"))["loop_drive"]
    assert {k: got[k] for k in set(want) - TIMES} == {k: want[k] for k in set(want) - TIMES}
    assert got["detections_fixed_gate"] < got["detections_drift_scaled_gate"]


def test_coupling_drive_records_equal_the_reference_tools(canned, tmp_path):
    """160 frames at the reference tool's other defaults (two turns): the
    KITTI errors, ATE, final error and the telemetry's turn / straight
    medians of both modes.  Where a number goes through float32 (the KITTI
    protocol's pose matrices, ``gt_delta``'s quaternion), it may lie one
    unit of its rounding off; every other number is equal."""
    args = ["--frames", "160", "--tag", "t"]
    want = reference_record(canned, "coupling_drive", tmp_path, *args)
    coupling_drive.main([*args, "--device", "cpu", "--out", str(tmp_path / "port.json")])
    got = json.load(open(tmp_path / "port.json"))
    assert set(got) == set(want)
    for key, rec in want.items():
        if key.startswith("coupling_production"):
            for k, v in rec.items():
                if k in ("mo_trans_pct", "mo_rot_deg_per_m"):
                    np.testing.assert_allclose(got[key][k], v, rtol=0,
                                               atol=10.0 ** -(4 if k == "mo_trans_pct" else 5))
                else:
                    assert got[key][k] == v, (key, k)
            continue
        assert got[key]["note"] == rec["note"]
        for mode in ("decoupled_D", "coupled_C"):
            g, w = got[key][mode], rec[mode]
            assert g["median_turn_yaw_deg_per_frame"] == w["median_turn_yaw_deg_per_frame"]
            for split in ("turn_frames", "straight_frames"):
                assert g[split].keys() == w[split].keys()
                for k in w[split]:
                    np.testing.assert_allclose(g[split][k], w[split][k], rtol=0, atol=1e-4)
    modes = [got["coupling_production_decoupled_D_t"], got["coupling_production_coupled_C_t"]]
    assert modes[0]["mo_trans_pct"] != modes[1]["mo_trans_pct"] and modes[0]["segments"] > 0


def test_coupling_scenarios_results_equal_the_reference_tools(canned, tmp_path):
    """The corridor and the highway at 12 frames: both scenarios' records,
    both modes, equal."""
    want = reference_record(canned, "coupling_scenarios", tmp_path,
                            "--frames", "12")["coupling_scenarios"]
    coupling_scenarios.main(["--frames", "12", "--device", "cpu",
                             "--out", str(tmp_path / "port.json")])
    got = json.load(open(tmp_path / "port.json"))["coupling_scenarios"]
    assert got == want


# runs a tool's module with the 64-beam preset shrunk to the runtime CLI
# test's tiny lidar sizes and a small camera
TOOL = textwrap.dedent("""
    import dataclasses, runpy, sys
    from vloam_tpu_torch import config as C
    small = C.kitti_hdl64().replace(
        scan=C.ScanConfig(ring_cap=128, max_points=4096, less_flat_cap=4096),
        mapping=C.MappingConfig(grid_w=5, grid_h=5, grid_d=3, corner_cube_cap=128,
                                surf_cube_cap=256, corner_stack_cap=256, surf_stack_cap=512))
    small = small.replace(visual=dataclasses.replace(small.visual, img_height=192,
                                                     img_width=624, max_corners=256,
                                                     max_features=256))
    C.kitti_hdl64 = lambda: small
    module = sys.argv[1]
    sys.argv = [module] + sys.argv[2:]
    try:
        runpy.run_module(module, run_name="__main__")
    finally:
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib",
                                                                            "vloam_tpu.")))
        assert not bad, bad
""")


def run_tool(name, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", TOOL, f"vloam_tpu_torch.tools.{name}", *args],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=600)


def test_loop_drive_tool(tmp_path):
    out = tmp_path / "VALIDATION_torch.json"
    res = run_tool("loop_drive", "--device", "cpu", "--frames", "30", "--tag", "_t",
                   "--out", str(out))
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert json.load(open(out)) == {"loop_drive_t": rec}
    want = dict_keys("tools/loop_drive.py", "result")
    assert want <= set(rec), want - set(rec)
    assert rec["frames"] == 30 and rec["laps"] == 1 and rec["keyframes"] == 3
    assert rec["device"] == "cpu" and rec["refine_report"]["loop_factors"] == 0
    assert np.isfinite(rec["raw_final_err_m"]) and rec["refined_final_err_m"] is not None


def test_coupling_drive_tool(tmp_path):
    out = tmp_path / "VALIDATION_torch.json"
    res = run_tool("coupling_drive", "--device", "cpu", "--frames", "8", "--straight", "4",
                   "--turn-frames", "2", "--tag", "t", "--out", str(out))
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.load(open(out))
    assert set(rec) == {"coupling_production_decoupled_D_t", "coupling_production_coupled_C_t",
                        "coupling_seed_telemetry_t"}
    want = dict_keys("tools/coupling_drive.py", "results[mode]")
    tele_want = dict_keys("tools/coupling_drive.py", "tele_summary[mode]")
    for mode in ("decoupled_D", "coupled_C"):
        r = rec[f"coupling_production_{mode}_t"]
        assert want <= set(r), want - set(r)
        assert r["mode"] == mode and r["frames"] == 8 and np.isfinite(r["final_err_m"])
        tele = rec["coupling_seed_telemetry_t"][mode]
        assert set(tele) == tele_want
        assert all(v is not None for v in tele["turn_frames"].values())
    assert json.loads(res.stdout.strip().splitlines()[-1]).keys() == {"decoupled_D", "coupled_C"}


def test_coupling_scenarios_tool(tmp_path):
    out = tmp_path / "VALIDATION_torch.json"
    res = run_tool("coupling_scenarios", "--device", "cpu", "--frames", "6", "--out", str(out))
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.load(open(out))["coupling_scenarios"]
    assert set(rec) == {"note", "corridor", "highway"}
    want = dict_keys("vloam_tpu/data/scenarios.py", "return run_scenario")
    for name in ("corridor", "highway"):
        assert set(rec[name]) == {"decoupled_D", "coupled_C"}
        for mode, r in rec[name].items():
            assert set(r) == want and r["mode"] == mode and r["frames"] == 6
    lines = res.stdout.splitlines()
    assert lines[0] == "[corridor] 6 frames, 5 m, degenerate LO geometry"
    assert any(line.startswith("[highway] 6 frames") for line in lines)


@pytest.mark.parametrize("name", ["loop_drive", "coupling_drive", "coupling_scenarios"])
def test_tools_refuse_the_reference_records(name, tmp_path):
    res = run_tool(name, "--device", "cpu", "--out", str(tmp_path / "VALIDATION_r05.json"))
    assert res.returncode == 2 and "record of the reference package" in res.stderr
    assert not (tmp_path / "VALIDATION_r05.json").exists()
