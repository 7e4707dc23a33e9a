"""Correction loops (``lsq/iteration.py:single_iteration``, on a card the
kernel of ``lsq/step_cuda.py``): the kernel's launches, every working type,
over the two-body Newton steps that ``outfit_tpu_torch.trace``'s count
``lsq_step.two_body`` counted, across the traced window; 1.0 when every
two-body step ran as the kernel.  A program without the kernel's launch
counter or without the count gets no hooks, and the metric reads None."""

import importlib

from portbench import program_counters as pc

KERNEL = "outfit_tpu_torch.lsq.step_cuda"


def hooks(kernel=KERNEL):
    """The counter hooks of the kernel's launches and of the two-body steps,
    or none where the program lacks either."""
    try:
        launches = getattr(importlib.import_module(kernel), "launches", None)
    except ModuleNotFoundError:
        return []
    steps = pc.hooks("lsq_step.two_body")
    if not isinstance(launches, dict) or not steps:
        return []
    return [("counter", f"{kernel}:launches")] + steps


HOOKS = hooks()


def read(run):
    if not HOOKS:
        return None
    launches, steps = (run.counts[path] for _, path in HOOKS)
    return launches / steps if steps else None
