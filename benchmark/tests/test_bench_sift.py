"""The SIFT cell (``sift.street1``): its configuration is the port's KITTI
preset with ImageUtil's SIFT path, the cell finds its files, the plain SIFT
(``plainref/ops/sift.py``) imports nothing of the program or of JAX, and the
two metrics it brings (``vo_device_ms``, every cell; ``sift_gather_roofline``)
read the right values on canned runs and traces, and nothing without their
span or kernel.  On a card: the TF32 control and the planted faults fail the
cell's limits (``test_bench_control``'s check, for this cell)."""

import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from conftest import BENCH, ROOT
from vbench import arith, spec
from vbench.main import Run
from vbench.trace import Trace

CELL = "sift.street1"
# the profiler's name of B2's run-time instantiation (read from a trace on the card), and
# of its P = 32 one
B2_P24 = "void (anonymous namespace)::gather_stack_kernel<0>(float const*, int, int, " \
         "int const*, int, int, int, float*)"
B2_P32 = B2_P24.replace("<0>", "<32>")
US = 1000   # ns


def test_config_is_the_port_preset_with_sift():
    import plainref.config as ref_config
    from vloam_tpu_torch import config as port_config
    f = json.load(open(os.path.join(BENCH, "configs", "kitti_hdl64_sift.json")))
    want = port_config.kitti_hdl64()
    want = want.replace(visual=dataclasses.replace(want.visual, optical_flow_match=False,
                                                   detector_type="sift",
                                                   descriptor_type="sift"))
    assert spec.build_config(port_config, f["vloam"]) == want
    assert dataclasses.asdict(spec.build_config(ref_config, f["vloam"])) == \
        dataclasses.asdict(want)
    assert (want.visual.matcher_type, want.visual.match_select, want.visual.match_ratio,
            want.visual.max_corners) == ("bf", "knn", 0.8, 1024)
    assert f["reduced"] == [] and f["name"] == "kitti_hdl64_sift"
    # the same file as the ORB cell's but for the two feature types
    orb = json.load(open(os.path.join(BENCH, "configs", "kitti_hdl64_orb.json")))
    orb["vloam"]["visual"].update(detector_type="sift", descriptor_type="sift")
    assert orb["vloam"] == f["vloam"]


def test_cell_finds_its_files():
    c = spec.load_cell(ROOT, CELL)
    assert c.chips == 1 and c.traffic["name"] == "street1"
    assert {m["name"] for m in c.per_layer} == {"vo_device_ms", "sift_gather_roofline"}
    assert {m["name"] for m in c.end_to_end} == {"frames_per_s", "setup_s"}
    assert {"vo_gap_m", "lo_gap_m", "mo_gap_m"} <= set(c.limits)
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    vo = next(m for m in bench["per_layer"] if m["name"] == "vo_device_ms")
    assert vo["workloads"] == ["klt.street1", "orb.street1", CELL]


def test_plain_sift_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [{!r}]; import plainref.ops.sift, plainref.image_util; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))").format(BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    top = out.stdout.strip()
    assert "vloam_tpu_torch" not in top and "'vloam_tpu'" not in top and "jax" not in top
    assert "plainref" in top


def stage_run(stages):
    return Run(None, None, dict(stages), [], [])


def test_vo_device_ms_on_a_canned_run():
    read = spec.metric_reader("vo_device_ms")
    stages = {"vloam_step": (1000.0, 10), "visual_odometry": (30.0, 10),
              "dev.visual_odometry": (45.0, 10)}
    assert read(stage_run(stages)) == pytest.approx(4.5)
    del stages["dev.visual_odometry"]
    assert read(stage_run(stages)) is None
    assert read(stage_run({"dev.visual_odometry": (45.0, 10)})) is None


def trace_run(ops, max_corners=1024):
    cell = SimpleNamespace(config={"vloam": {"visual": {"max_corners": max_corners}}})
    window = SimpleNamespace(trace=None if ops is None else Trace(device_ops=ops))
    return Run(cell, window, {}, [], [])


def test_sift_gather_roofline_on_a_canned_trace():
    read = spec.metric_reader("sift_gather_roofline")
    # eight calls of 3.5 us and one of 7 us; the P = 32 form and other kernels ignored
    ops = [(B2_P24, k * 100 * US, k * 100 * US + 3500) for k in range(8)]
    ops += [(B2_P24, 900 * US, 907 * US), (B2_P32, 0, 50 * US), ("pair_sweep<8, 16>", 0, 9 * US)]
    n = 1024
    want_bytes = 9 * (n * 24 * 24 * 4 + n * 2 * 4)
    want = 100.0 * (want_bytes / arith.PEAK_BW) / (35e-6)
    assert read(trace_run(ops)) == pytest.approx(want)
    assert 0.0 < read(trace_run(ops)) < 100.0
    # 1023 corners: 255 an octave, 1020 keypoints a call
    assert read(trace_run(ops, 1023)) == pytest.approx(want * 1020 / 1024, rel=1e-3)
    assert read(trace_run([op for op in ops if op[0] != B2_P24])) is None
    assert read(trace_run(None)) is None


@pytest.mark.card
def test_control_and_faults_are_not_correct(card):
    """The readings above the SIFT cell's limits, as ``test_bench_control``
    holds them for the other cells: the TF32 control and each planted fault
    fail one of the gaps, the sound program none."""
    from control import FAULTS, readings
    c = spec.load_cell(ROOT, CELL)
    got = readings(c, 2**31 + 99, card, control=True)
    gap_limits = {k: v for k, v in c.limits.items() if k.endswith("_gap_m")}
    for variant in ("tf32",) + tuple(FAULTS):
        assert any(got[variant][k] > v for k, v in gap_limits.items()), (variant, got[variant])
    assert all(got["program"][k] <= v for k, v in gap_limits.items()), got["program"]
