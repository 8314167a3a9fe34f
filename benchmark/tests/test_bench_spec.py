"""The benchmark's data: every cell of BENCHMARK.json finds its files by
name, the configuration files hold the port's presets as run, and the file
keeps the contract's shapes."""

import dataclasses
import json
import os
import re

import pytest

from conftest import BENCH, ROOT
from vbench import spec

BENCH_JSON = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH_JSON["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    c = spec.load_cell(ROOT, cell)
    chains = ("vo", "lo", "mo")
    assert {f"{ch}_gap_m" for ch in chains} <= set(c.limits) <= \
        {f"{ch}_{k}" for ch in chains for k in ("gap_m", "drift_pct")}
    assert {m["name"] for m in c.end_to_end} >= {"frames_per_s", "setup_s"}
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    for key in ("frames_per_drive", "warmup_frames", "judged_frames", "drift_from_m",
                "sync_frames", "trace_seconds"):
        assert key in c.traffic


@pytest.mark.parametrize("name,optical_flow", [("kitti_hdl64_klt", True),
                                               ("kitti_hdl64_orb", False)])
def test_configs_are_the_port_presets(name, optical_flow):
    import plainref.config as ref_config
    from vloam_tpu_torch import config as port_config
    f = json.load(open(os.path.join(BENCH, "configs", f"{name}.json")))
    want = port_config.kitti_hdl64()
    want = want.replace(visual=dataclasses.replace(want.visual, optical_flow_match=optical_flow))
    assert spec.build_config(port_config, f["vloam"]) == want
    assert dataclasses.asdict(spec.build_config(ref_config, f["vloam"])) == \
        dataclasses.asdict(want)
    assert f["reduced"] == []


def test_config_file_must_be_whole():
    from vloam_tpu_torch import config as port_config
    f = json.load(open(os.path.join(BENCH, "configs", "kitti_hdl64_klt.json")))
    del f["vloam"]["scan"]["ring_cap"]
    with pytest.raises(ValueError):
        spec.build_config(port_config, f["vloam"])


def test_contract_shapes():
    b = BENCH_JSON
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for m in b["end_to_end"]:
        assert {"name", "unit", "better", "bound", "source"} <= set(m) <= \
            {"name", "unit", "better", "bound", "source", "workloads"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert len(c["source"]) <= 200 and c["file"].startswith("benchmark/")
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
