"""Host preparation (span ``fit.prepare`` of ``outfit_tpu_torch.trace``:
``prepare_dataset``, ``_padded_layout``, the device bases' upload,
``_screen_seeds``): its host wall in milliseconds per 1,000 trajectories of
the traced window, timed inside the program."""

from portbench import program_counters as pc

HOOKS = pc.hooks("spans.fit_prepare.wall_ns")


def read(run):
    d = pc.deltas(run, HOOKS)
    return d[0] / 1e6 / pc.kfits(run) if d else None
