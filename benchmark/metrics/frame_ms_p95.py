"""frame_ms_p95: the 95th percentile (ms) of the host clock around each
``process()`` call that returned inside the window.  The
call ends in the frame's fetch, which waits for the device."""

from vbench import arith


def read(run):
    ms = [(f.end - f.start) * 1e3 for f in run.window.counted()]
    return arith.p95(ms) if ms else None
