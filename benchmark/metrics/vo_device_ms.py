"""vo_device_ms: VO a frame on the card (ms), from VloamDriver's StageTimer:
the ``dev.visual_odometry`` device span (two CUDA timing events around the
VO segment, captured or eager), summed over the window drivers and divided
by the frames of their ``vloam_step`` stage.  A host span around a replayed
graph times only its launch; this one times the card's work.  A program
without the span reads nothing."""

SPAN = "dev.visual_odometry"


def read(run):
    frames = run.stages.get("vloam_step", (0.0, 0))[1]
    return run.stages[SPAN][0] / frames if frames and SPAN in run.stages else None
