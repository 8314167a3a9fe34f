"""laser_mapping_ms: MO a frame (ms), from VloamDriver's StageTimer: the
step's ``laser_mapping`` span around ``mapping_step`` (its four waits for
the card included), summed over the window drivers and divided by the
frames of their ``vloam_step`` stage.  A program without the span reads
nothing."""

SPAN = "laser_mapping"


def read(run):
    frames = run.stages.get("vloam_step", (0.0, 0))[1]
    return run.stages[SPAN][0] / frames if frames and SPAN in run.stages else None
