"""IOD scoring (span ``iod.scoring`` of ``outfit_tpu_torch.trace``, inside
``iod/scoring.py:rms_orbit_error``: the RMS of the candidates over their
windows, and of the polished winners): its host wall less the time blocked
in its device reads, in milliseconds per 1,000 trajectories of the traced
window: the host's dispatch."""

from portbench import program_counters as pc

HOOKS = pc.hooks("spans.iod_scoring.wall_ns", "spans.iod_scoring.blocked_ns")


def read(run):
    d = pc.deltas(run, HOOKS)
    return (d[0] - d[1]) / 1e6 / pc.kfits(run) if d else None
