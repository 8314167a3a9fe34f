"""native_grid_pct: the share (%) of the window drivers' frames whose raw
cloud the host library's threaded gridder turned into the ring grid: 100 ×
the count of the ``grid.native`` span over the count of the ``host_grid``
stage, from VloamDriver's StageTimer.  A program without the span reads
nothing."""

SPAN = "grid.native"


def read(run):
    frames = run.stages.get("host_grid", (0.0, 0))[1]
    return 100.0 * run.stages[SPAN][1] / frames if frames and SPAN in run.stages else None
