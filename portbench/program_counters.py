"""The program's own spans and counters (``outfit_tpu_torch.trace``) as the
metric readers name them: the harness's ``("counter", ...)`` hooks, and the
deltas a traced window read through them.

A program without that module, or without a named counter, gets no hooks,
and the readers return None: the metrics are then left out of the line."""

import importlib

MODULE = "outfit_tpu_torch.trace"


def _resolves(attr):
    try:
        owner = importlib.import_module(MODULE)
    except ModuleNotFoundError:
        return False
    for name in attr.split("."):
        if not hasattr(owner, name):
            return False
        owner = getattr(owner, name)
    return isinstance(owner, int)


def hooks(*attrs):
    """``("counter", "outfit_tpu_torch.trace:<attr>")`` of each of
    ``attrs`` (dotted paths such as ``spans.fit.reads``), or none where the
    program lacks one of them."""
    if not all(_resolves(a) for a in attrs):
        return []
    return [("counter", f"{MODULE}:{a}") for a in attrs]


def deltas(run, hooks):
    """What each of ``hooks`` counted over the window, in their order; None
    without hooks."""
    if not hooks:
        return None
    return [run.counts[path] for _, path in hooks]


def kfits(run):
    """The window's trajectories, in thousands."""
    return sum(r["n"] for r in run.records) / 1e3
