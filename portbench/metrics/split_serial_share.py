"""Device split (``parallel/sharding.py:map_devices``, as the correction
calls it from ``lsq/api.py``): the share of the traced window's wall spent
outside the per-device workers (preparation, the observer cache, the
joins), 1 - synchronised wall inside ``map_devices`` / window.  Read in a
cell whose traffic sets ``"devices": "all"``; in a one-card fit the one
worker runs inline and the share is that of the serial part all the same."""

HOOKS = [("span", "outfit_tpu_torch.lsq.api:map_devices")]


def read(run):
    t = run.spans.get(HOOKS[0][1])
    return 1.0 - sum(t) / run.window_s if t and run.window_s > 0 else None
