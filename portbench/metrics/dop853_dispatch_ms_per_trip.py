"""DOP853 loop (span ``dop853`` of ``outfit_tpu_torch.trace``, inside
``dop853_integrate``): its host wall less the time blocked in its device
reads, in milliseconds per loop trip, over the program's own trip count
(site ``dop853``) in the traced window."""

from portbench import program_counters as pc

HOOKS = pc.hooks("spans.dop853.wall_ns", "spans.dop853.blocked_ns", "sites.dop853.trips")


def read(run):
    d = pc.deltas(run, HOOKS)
    return (d[0] - d[1]) / 1e6 / d[2] if d and d[2] else None
