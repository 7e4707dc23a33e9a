"""Escalation flush (counter ``escalation.rows`` of
``outfit_tpu_torch.trace``, in ``lsq/api.py:_fit_lsq_stream_escalating``):
the rows handed to the richer stages over the trajectories of the traced
window."""

from portbench import program_counters as pc

HOOKS = pc.hooks("escalation.rows")


def read(run):
    d = pc.deltas(run, HOOKS)
    return d[0] / (1e3 * pc.kfits(run)) if d else None
