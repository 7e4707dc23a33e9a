"""Fit path: the program's device reads (host syncs: the loops' exit tests,
the copy-backs; every site of ``outfit_tpu_torch.trace``) while a ``fit``
span was open, per 1,000 trajectories of the traced window."""

from portbench import program_counters as pc

HOOKS = pc.hooks("spans.fit.reads")


def read(run):
    d = pc.deltas(run, HOOKS)
    return d[0] / pc.kfits(run) if d else None
