"""IOD f-g correction (site ``iod_fg`` of ``outfit_tpu_torch.trace``, the
loop's exit test): the candidates still live at a trip over all the
candidates, summed over the traced window's trips."""

from portbench import program_counters as pc

HOOKS = pc.hooks("sites.iod_fg.live", "sites.iod_fg.lanes")


def read(run):
    d = pc.deltas(run, HOOKS)
    return d[0] / d[1] if d and d[1] else None
