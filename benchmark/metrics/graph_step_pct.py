"""graph_step_pct: the share (%) of the window drivers' frames whose step
replayed its captured CUDA graphs: 100 × the count of the ``graph_step``
span over the count of the ``vloam_step`` stage, from VloamDriver's
StageTimer.  A program without the span reads nothing."""

SPAN = "graph_step"


def read(run):
    frames = run.stages.get("vloam_step", (0.0, 0))[1]
    return 100.0 * run.stages[SPAN][1] / frames if frames and SPAN in run.stages else None
