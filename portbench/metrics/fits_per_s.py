"""Trajectories whose results came back to the host, over the time from
the window's start to the return of the last call started in it (host
preparation and result assembly inside)."""


def read(run):
    return sum(r["n"] for r in run.records) / run.window_s
