"""DOP853 loop (site ``dop853`` of ``outfit_tpu_torch.trace``, the loop's
exit test): the lanes still unfinished at a trip over all the lanes,
summed over the traced window's trips."""

from portbench import program_counters as pc

HOOKS = pc.hooks("sites.dop853.live", "sites.dop853.lanes")


def read(run):
    d = pc.deltas(run, HOOKS)
    return d[0] / d[1] if d and d[1] else None
