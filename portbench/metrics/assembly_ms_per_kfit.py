"""Result assembly (span ``fit.assemble`` of ``outfit_tpu_torch.trace``:
``_add_results``, ``_as_table``): its host wall in milliseconds per 1,000
trajectories of the traced window, timed inside the program."""

from portbench import program_counters as pc

HOOKS = pc.hooks("spans.fit_assemble.wall_ns")


def read(run):
    d = pc.deltas(run, HOOKS)
    return d[0] / 1e6 / pc.kfits(run) if d else None
