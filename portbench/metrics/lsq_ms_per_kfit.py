"""Correction loops (``lsq/loop.py``, ``lsq/iteration.py``, entered through
``lsq/api.py:_correct``, once per device chunk): synchronised wall in
milliseconds per 1,000 trajectories of the traced window, summed over the
chunks (worker threads of a split each add their own)."""

HOOKS = [("span", "outfit_tpu_torch.lsq.api:_correct")]


def read(run):
    t = run.spans.get(HOOKS[0][1])
    return 1e3 * sum(t) / (sum(r["n"] for r in run.records) / 1e3) if t else None
