"""Lanes propagated to their end epoch (status 0), over the time from the
window's start to the return of the last call started in it."""


def read(run):
    return sum(r["done"] for r in run.records) / run.window_s
