"""Correction loops: the mean of the results' ``total_newton_iterations``
(the program's own count, the mixed pre-warm's trips included) over the
traced window's trajectories."""


def read(run):
    return sum(r["newton"] for r in run.records) / sum(r["n"] for r in run.records)
