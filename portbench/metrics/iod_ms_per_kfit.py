"""IOD (``iod/api.py``, the batch IOD stage ``_IodBatch.fit``): its
synchronised wall in milliseconds per 1,000 trajectories of the traced
window."""

HOOKS = [("span", "outfit_tpu_torch.iod.api:_IodBatch.fit")]


def read(run):
    t = run.spans.get(HOOKS[0][1])
    return 1e3 * sum(t) / (sum(r["n"] for r in run.records) / 1e3) if t else None
