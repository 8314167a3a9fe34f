"""scan_registration_ms: scan registration a frame (ms), from VloamDriver's
StageTimer: the step's ``scan_registration`` span around the feature
extraction (``extract_features_from_grid``), summed over the window drivers
and divided by the frames of their ``vloam_step`` stage.  A program without
the span reads nothing."""

SPAN = "scan_registration"


def read(run):
    frames = run.stages.get("vloam_step", (0.0, 0))[1]
    return run.stages[SPAN][0] / frames if frames and SPAN in run.stages else None
