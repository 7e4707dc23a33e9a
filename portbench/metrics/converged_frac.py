"""Share of the window's trajectories whose correction converged (LSQ
status 1): the quality a survey user gets for the time."""


def read(run):
    return sum(r["converged"] for r in run.records) / sum(r["n"] for r in run.records)
