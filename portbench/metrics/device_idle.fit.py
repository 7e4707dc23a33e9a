"""Device: 1 - busy / wall of the profiled call of a fitting cell, busy
being the union of the device's kernel and copy intervals in the
profiler's trace, as a mean over the cell's cards."""


def read(run):
    p = run.profile
    return 1.0 - p["busy_s"] / p["window_s"] if p.get("busy_s") else None
