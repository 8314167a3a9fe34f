"""gpu_idle_pct: 100 x (1 - busy / window) over the traced span, busy being
the union of the device operations' intervals (one process drives the card,
so the union is the time in which an operation ran)."""


def read(run):
    tr = run.window.trace
    if tr is None or not tr.device_ops or tr.window_s() <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())
