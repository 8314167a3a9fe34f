"""``native_grid_pct``: the share of the window drivers' frames gridded by the
host library, from the ``grid.native`` span's count over the ``host_grid``
stage's; nothing on a program without the span."""

from types import SimpleNamespace

import pytest

from vbench import spec
from vbench.main import Run

STAGES = {"host_grid": (80.0, 40), "grid.native": (60.0, 40), "vloam_step": (900.0, 40)}


def run_with(stages):
    return Run(None, SimpleNamespace(trace=None, drivers={}), dict(stages), [], [])


@pytest.mark.parametrize("native, want", [(40, 100.0), (30, 75.0)])
def test_reads_the_share_of_natively_gridded_frames(native, want):
    stages = dict(STAGES, **{"grid.native": (60.0, native)})
    assert spec.metric_reader("native_grid_pct")(run_with(stages)) == pytest.approx(want)


@pytest.mark.parametrize("stages", [
    {k: v for k, v in STAGES.items() if k != "grid.native"},   # a program without the span
    {"grid.native": (60.0, 40)},                                 # no frames
])
def test_reads_nothing_without_the_span_or_frames(stages):
    assert spec.metric_reader("native_grid_pct")(run_with(stages)) is None


def test_traced_run_reads_every_frame_gridded_natively():
    """A traced run on the CPU, with the host library built, grids every
    frame of the window in it."""
    from conftest import run_small, small_cell
    from vloam_tpu_torch.runtime import native
    if not native.available():
        pytest.skip(f"no host library: {native.toolchain_missing()}")
    res = run_small(small_cell(frames=4, judged=2), seconds=3.0, trace=True)
    assert res["metrics"]["native_grid_pct"]["value"] == pytest.approx(100.0)
