"""idle_in_dispatch_pct: the share (%) of the card's idle time in the traced
span during which the host was dispatching the frame step: inside one of
the step's four layer spans and outside every ``wait.<site>`` span.

Idle time is the traced span less the union of the device operations.  The
host's spans are the window drivers' StageTimer timelines, stamped on the
profiler's clock.  The rest of the idle time lies in the host stages, the
uploads and the glue between the layers, or in the waits themselves.  A
program without timelines reads nothing."""

from vbench import arith

LAYERS = ("visual_odometry", "scan_registration", "laser_odometry", "laser_mapping")


def intersect(a, b) -> list:
    """The (start, end) stretches that lie in both merged, sorted lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def read(run):
    tr = run.window.trace
    timelines = [getattr(d.timer, "timeline", None) for d in run.window.drivers.values()]
    if tr is None or not tr.device_ops or not timelines or None in timelines:
        return None
    spans = [sp for tl in timelines for sp in tl]
    layers = arith.merged([(s, e) for name, s, e in spans if name in LAYERS])
    waits = arith.merged([(s, e) for name, s, e in spans if name.startswith("wait.")])
    idle = arith.gaps([(s, e) for _, s, e in tr.device_ops], *tr.span_ns)
    idle_ns = sum(e - s for s, e in idle)
    if not layers or idle_ns <= 0:
        return None
    in_layers = intersect(idle, layers)
    in_waits = intersect(in_layers, waits)
    return 100.0 * (arith.union_length(in_layers) - arith.union_length(in_waits)) / idle_ns
