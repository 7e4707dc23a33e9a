"""Observer cache (``observer/cache.py``): wall milliseconds of one
``ObserverCache.build``, the devices synchronised before and after; the
mean over the builds of the traced window."""

HOOKS = [("span", "outfit_tpu_torch.observer.cache:ObserverCache.build")]


def read(run):
    t = run.spans.get(HOOKS[0][1])
    return 1e3 * sum(t) / len(t) if t else None
