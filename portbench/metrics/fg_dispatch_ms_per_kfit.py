"""IOD f-g correction (span ``iod.fg_correction`` of
``outfit_tpu_torch.trace``, inside ``iod/gauss.py:_fg_correction``): its
host wall less the time blocked in its device reads, in milliseconds per
1,000 trajectories of the traced window: the host's dispatch."""

from portbench import program_counters as pc

HOOKS = pc.hooks("spans.iod_fg_correction.wall_ns", "spans.iod_fg_correction.blocked_ns")


def read(run):
    d = pc.deltas(run, HOOKS)
    return (d[0] - d[1]) / 1e6 / pc.kfits(run) if d else None
