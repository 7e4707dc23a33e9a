"""IOD f-g correction (``iod/gauss.py:_fg_correction`` over
``kepler/universal.py``): its synchronised wall as a share of the IOD
stage's, over the traced window."""

HOOKS = [("span", "outfit_tpu_torch.iod.api:_IodBatch.fit"), ("span", "outfit_tpu_torch.iod.gauss:_fg_correction")]


def read(run):
    iod, fg = (run.spans.get(p) for _, p in HOOKS)
    return sum(fg) / sum(iod) if iod and fg else None
