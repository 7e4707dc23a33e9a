"""Correction loops (span ``correct`` of ``outfit_tpu_torch.trace``, inside
``lsq/api.py:_correct``, once per device chunk): its host wall less the time
blocked in its device reads, in milliseconds per 1,000 trajectories of the
traced window: the host's dispatch."""

from portbench import program_counters as pc

HOOKS = pc.hooks("spans.correct.wall_ns", "spans.correct.blocked_ns")


def read(run):
    d = pc.deltas(run, HOOKS)
    return (d[0] - d[1]) / 1e6 / pc.kfits(run) if d else None
