"""``fit_lsq_stream`` over a pool of distinct synthetic datasets, unseeded:
the survey short-arc service (Gauss IOD, then the correction).

Traffic file keys: ``pool`` (distinct datasets built at set-up),
``population_seed`` (their orbits and noise), ``iod_seed`` (the seed the
stream hands the IOD's noise draws), ``stream`` (the stream's keyword
arguments), ``check`` (see :mod:`portbench.checks`); ``--seed`` orders the
pool and draws the check's sample.  The window hands the stream fresh
dataset objects, the pool's in that order, while the window is open and
then until the pass through the pool ends: every window holds whole
passes, so its work does not hang on which datasets fall inside it (the
datasets cost unlike amounts: each as much as its slowest trajectory's
loops).  A call is one dataset, from the moment the stream takes it to its
results."""

import time

import numpy as np

from portbench import checks
from portbench.drivers import common
from portbench.traffic import synthetic


def setup(run):
    import torch  # noqa: F401

    p = dict(run.config["population"], **run.config["observations"], population_seed=run.traffic["population_seed"])
    p.update(run.traffic.get("sizes", {}))
    pool = [synthetic.observations(i, p) for i in range(run.traffic["pool"])]
    iod, cfg = common.settings(run.config)
    order = synthetic.rng(run.seed, 6).permutation(len(pool)).tolist()
    return dict(eph=common.ephemeris(run), pool=pool, order=order, iod=iod, cfg=cfg, params=p)


def _dataset(d, k):
    """A fresh ``ObsDataset`` of pool dataset ``k``.  Its trajectories are
    named by ``k`` alone: the program keys each trajectory's IOD noise
    draws by its name, so a dataset does the same work in every pass and
    at every place in the order."""
    from outfit_tpu_torch import Observer

    T, n = d["mjd"].shape
    return common.dataset(d["mjd"].ravel(), d["ra"].ravel(), d["dec"].ravel(), d["sigma"].ravel(),
                          d["sigma"].ravel(), np.repeat(np.arange(T, dtype=np.int64), n), np.zeros(T * n, np.int64),
                          [Observer.geocenter()], f"S{k:03d}_")


def _stream(run, feed):
    from outfit_tpu_torch import fit_lsq_stream

    s = run.state
    return fit_lsq_stream(feed, s["eph"], s["iod"], s["cfg"], run.traffic["iod_seed"],
                          device=run.devices[0] if len(run.devices) == 1 else run.devices, **run.traffic["stream"])


def window(run, deadline):
    pool, order = run.state["pool"], run.state["order"]
    records = []

    def feed():
        i = 0
        while time.perf_counter() < deadline or i % len(pool):
            k = order[i % len(pool)]
            records.append(dict(index=k, n=pool[k]["mjd"].shape[0], t0=time.perf_counter()))
            yield _dataset(pool[k], k)
            i += 1

    for _, out in _stream(run, feed()):
        records[-1]["t1"] = time.perf_counter()
        records[-1]["out"] = out
    return records


def call(run, i):
    pool = run.state["pool"]
    k = run.state["order"][max(i, 0) % len(pool)]
    t0 = time.perf_counter()
    ((_, out),) = list(_stream(run, iter([_dataset(pool[k], k)])))
    return dict(index=k, n=pool[k]["mjd"].shape[0], t0=t0, t1=time.perf_counter(), out=out)


def rows(rec):
    return common.rows_from_table(rec["out"])


def tally(run):
    return common.tally(run, rows)


def check(run, replace=None):
    """The sampled rows against the reference; the truth orbits stand for
    the IOD's start where the reference decides convergence on its own."""
    pool = run.state["pool"]
    return checks.check_fits(run, [(rows(r), pool[r["index"]]) for r in run.records], truth=True, replace=replace)
