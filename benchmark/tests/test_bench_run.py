"""A whole run of the harness on the CPU at small sizes: the result line's
shape, the comparison's verdict on a sound run and on runs whose timed path
is broken underneath, and the modules the run loaded.  The look for a card
is skipped: ``vbench.main.run`` is called with the CPU as its device."""

import contextlib
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT, run_small, small_cell


def test_sound_run_result_line():
    res = run_small(small_cell(), seconds=6.0)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "problems",
                         "checks"]
    assert res["correct"] is True, res
    assert res["failed"] == 0 and res["attempted"] >= 3
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert res["metrics"]["frames_per_s"]["unit"] == "frames/s"
    assert res["metrics"]["setup_s"]["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == set(small_cell().limits)
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(res)


def stale_state(monkeypatch):
    """The frame step returns the state it was given."""
    from vloam_tpu_torch.runtime import driver
    real = driver.vloam_step

    def step(state, *a, **kw):
        return state, real(state, *a, **kw)[1]
    monkeypatch.setattr(driver, "vloam_step", step)


def altered_answer(monkeypatch):
    """From frame 1 on, the step's VO motion is moved by twice the VO
    limit along x, where the step produces it."""
    from vbench import spec
    from vloam_tpu_torch.runtime import driver
    real = driver.vloam_step
    shift = 2 * spec.load_cell(ROOT, "klt.street1").limits["vo_gap_m"]

    def step(state, *a, **kw):
        new, out = real(state, *a, **kw)
        if state.count >= 1:
            d = torch.zeros_like(out.vo_delta)
            d[4] = shift
            out = out._replace(vo_delta=out.vo_delta + d)
        return new, out
    monkeypatch.setattr(driver, "vloam_step", step)


def dropped_frames(drv):
    """Every second frame fed returns without being processed: half of the
    work left out."""
    real, n = drv.process, [0]

    def process(image, cloud):
        n[0] += 1
        return real(image, cloud) if n[0] % 2 else None
    drv.process = process


@pytest.mark.parametrize("fault", ["stale_state", "altered_answer", "dropped_frames",
                                   "map_unchanged"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    import control
    cell = small_cell()
    wrap = None
    with contextlib.ExitStack() as stack:
        if fault == "stale_state":
            stale_state(monkeypatch)
        elif fault == "altered_answer":
            altered_answer(monkeypatch)
        elif fault == "dropped_frames":
            wrap = dropped_frames
        else:
            stack.enter_context(control.FAULTS[fault]())
        res = run_small(cell, seconds=6.0, wrap_driver=wrap)
    assert res["correct"] is False, res["checks"]


def test_no_card_no_result():
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "klt.street1", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


SCRIPT = r"""
import sys, json
sys.path[:0] = [{bench!r}, {root!r}]
from conftest import run_small, small_cell
res = run_small(small_cell(frames=4, judged=2), seconds=3.0)
from vbench.main import forbidden_modules
print(json.dumps({{"bad": forbidden_modules(), "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_run_loads_no_jax():
    """After a small run, no module whose top-level name is jax, jaxlib,
    flax or vloam_tpu (compared whole: vloam_tpu_torch is the port) is
    loaded."""
    code = SCRIPT.format(bench=os.path.join(BENCH, "tests"), root=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert "vloam_tpu_torch" in got["top"] and "vloam_tpu" not in got["top"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [{!r}]; import plainref.driver, plainref.models.vloam; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))").format(BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    top = out.stdout.strip()
    assert "vloam_tpu_torch" not in top and "'vloam_tpu'" not in top and "jax" not in top
    imports = re.compile(r"^\s*(from|import)\s+(vloam_tpu|jax)\b", re.M)
    for dirpath, _, files in os.walk(os.path.join(BENCH, "plainref")):
        for f in files:
            if f.endswith(".py"):
                assert not imports.search(open(os.path.join(dirpath, f)).read()), f
