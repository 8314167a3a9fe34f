"""kernels_per_frame: device operations (kernels, copies, fills) in the
profiler's trace, divided by the frames in the traced span.  A frame counts
by the share of its process() call that lies inside the span."""


def traced_frames(run) -> float:
    t0, t1 = run.window.trace_t
    n = 0.0
    for f in run.window.frames:
        inside = min(f.end, t1) - max(f.start, t0)
        if inside > 0:
            n += inside / (f.end - f.start)
    return n


def read(run):
    tr = run.window.trace
    if tr is None or not tr.device_ops:
        return None
    n = traced_frames(run)
    return len(tr.device_ops) / n if n > 0 else None
