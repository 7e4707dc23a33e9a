"""Escalation flush (span ``escalate`` of ``outfit_tpu_torch.trace``, around
each flush of ``lsq/api.py:_fit_lsq_stream_escalating``: the held
datasets' failures gathered, refitted by the richer stages and patched in):
its host wall in milliseconds per 1,000 trajectories of the traced
window."""

from portbench import program_counters as pc

HOOKS = pc.hooks("spans.escalate.wall_ns")


def read(run):
    d = pc.deltas(run, HOOKS)
    return d[0] / 1e6 / pc.kfits(run) if d else None
