"""``graph_step_pct``: the share of the window drivers' frames whose step
replayed its CUDA graphs, from the ``graph_step`` span's count over the
``vloam_step`` stage's; nothing on a program without the span."""

from types import SimpleNamespace

import pytest

from vbench import spec
from vbench.main import Run

STAGES = {"vloam_step": (900.0, 40), "visual_odometry": (100.0, 40),
          "graph_step": (300.0, 37), "host_grid": (700.0, 40)}


def run_with(stages):
    return Run(None, SimpleNamespace(trace=None, drivers={}), dict(stages), [], [])


def test_reads_the_share_of_replayed_frames():
    assert spec.metric_reader("graph_step_pct")(run_with(STAGES)) == pytest.approx(92.5)


@pytest.mark.parametrize("stages", [
    {k: v for k, v in STAGES.items() if k != "graph_step"},   # a program without the span
    {"graph_step": (300.0, 37)},                                # no frames
])
def test_reads_nothing_without_the_span_or_frames(stages):
    assert spec.metric_reader("graph_step_pct")(run_with(stages)) is None
