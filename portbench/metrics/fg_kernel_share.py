"""IOD f-g correction (``iod/gauss.py:_fg_correction``, on a card the kernel
of ``iod/fg_correction_cuda.py``): the kernel's launches, both working
types, over the calls of the span ``iod.fg_correction`` of
``outfit_tpu_torch.trace``, across the traced window; 1.0 when every call
ran as the kernel.  A program without the kernel's launch counter gets no
hooks, and the metric reads None."""

import importlib

from portbench import program_counters as pc

KERNEL = "outfit_tpu_torch.iod.fg_correction_cuda"


def hooks(kernel=KERNEL):
    """The counter hooks of the kernel's launches and of the span's calls,
    or none where the program lacks either."""
    try:
        launches = getattr(importlib.import_module(kernel), "launches", None)
    except ModuleNotFoundError:
        return []
    calls = pc.hooks("spans.iod_fg_correction.calls")
    if not isinstance(launches, dict) or not calls:
        return []
    return [("counter", f"{kernel}:launches")] + calls


HOOKS = hooks()


def read(run):
    if not HOOKS:
        return None
    launches, calls = (run.counts[path] for _, path in HOOKS)
    return launches / calls if calls else None
