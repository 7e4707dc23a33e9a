"""``fit_lsq_stream_escalating`` over a pool of tilings of real astrometry,
unseeded: the catalogue refit from astrometry alone, a lean IOD and
correction streamed over every dataset and the rows that fail it refitted
by the richer stages in one batched pass per flush.

Configuration keys: ``iod`` and ``correction`` (the lean stage, the one
the sampled rows' reference corrects under), ``escalation.stages`` (the
richer stages, each ``iod`` and ``correction``; a control with none leaves
the lean results unpatched), ``fit_seed`` (the seed the stream hands the
IOD), ``stream`` (the stream's keyword arguments).  Traffic file keys:
``pool`` (distinct tilings built at set-up), ``population_seed`` (their
noise), ``flush_every``, ``sizes`` (optional, the tests' small
``n_traj``), ``check`` (see :mod:`portbench.checks`; ``check.iod`` that of
:mod:`portbench.iod_check`; ``check.escalated`` that of the escalated
rows, :func:`check_escalated`).

The work does not hang on ``--seed``, which orders the rows inside each
tiling and draws the check's sample, and does nothing else:

* each row is named by its place before the seed's permutation, so its IOD
  noise draws (keyed by the name) follow the row;
* the pool is handed over in a fixed order, whole passes a window, and
  ``flush_every`` is the pool's size: each dataset holds the same place in
  the stream's held buffer, which keys an escalated row's noise draws, and
  every window ends on a flush.

At set-up each tiling also runs once through the lean stage alone, to find
the rows the check holds to the reference after their refit.

A call is one dataset, from the moment the stream takes it to the moment
it is yielded with its failures patched; a flush's time falls in the call
that triggers it (and in those of the datasets it holds)."""

import time
from types import SimpleNamespace

import numpy as np

from portbench import checks, iod_check
from portbench.drivers import common
from portbench.drivers.seeded import _dataset
from portbench.traffic import mpc
from portbench.traffic.synthetic import rng


def setup(run):
    from outfit_tpu_torch import Observer

    obs = run.config["observations"]
    n_traj = run.traffic.get("sizes", {}).get("n_traj", obs["n_traj"])
    pool = []
    for i in range(run.traffic["pool"]):
        d = mpc.tiling(run.seed, i, obs["fixtures"], n_traj, run.traffic["population_seed"])
        st = d["stations"]
        d["observers"] = [Observer.from_parallax(st["longitude"][k], st["rho_cos_phi"][k], st["rho_sin_phi"][k],
                                                 code=c) for k, c in enumerate(st["codes"])]
        # the permutation mpc.tiling applied to the rows: row t holds the
        # tiling's row order[t]
        order = rng(run.seed, 5, i).permutation(n_traj)
        d["traj_ids"] = [f"U{i:02d}_{int(r):06d}" for r in order]
        pool.append(d)
    stages = [common.settings(s) for s in [run.config] + run.config["escalation"]["stages"]]
    eph = common.ephemeris(run)
    return dict(eph=eph, pool=pool, stages=stages, escalated=_lean_failures(run, eph, pool, stages[0]))


def _lean_failures(run, eph, pool, lean):
    """Per tiling of the pool, the rows the lean stage alone leaves
    unconverged: those the stream's default predicate hands to the richer
    stages.  Found at set-up by :func:`fit_lsq_stream`, and used only to
    pick the rows :func:`check_escalated` holds to the reference."""
    from outfit_tpu_torch import fit_lsq_stream

    out = fit_lsq_stream((_dataset(d) for d in pool), eph, *lean, run.config["fit_seed"], device=run.devices[0],
                         **run.config["stream"])
    return [np.nonzero(~np.asarray(table.converged))[0] for _, table in out]


def _stream(run, feed, flush_every):
    from outfit_tpu_torch import fit_lsq_stream_escalating

    s = run.state
    return fit_lsq_stream_escalating(feed, s["eph"], s["stages"], run.config["fit_seed"], flush_every=flush_every,
                                     device=run.devices[0], **run.config["stream"])


def window(run, deadline):
    pool = run.state["pool"]
    records = []

    def feed():
        i = 0
        while time.perf_counter() < deadline or i % len(pool):
            k = i % len(pool)
            records.append(dict(index=k, n=len(pool[k]["traj_ids"]), t0=time.perf_counter()))
            yield _dataset(pool[k])
            i += 1

    done = 0
    for _, out in _stream(run, feed(), run.traffic["flush_every"]):
        records[done]["t1"] = time.perf_counter()
        records[done]["out"] = out
        done += 1
    return records


def call(run, i):
    """Dataset ``i`` of the pool alone through the stream: its lean stage,
    then the flush of its own failures."""
    pool = run.state["pool"]
    k = max(i, 0) % len(pool)
    t0 = time.perf_counter()
    ((_, out),) = list(_stream(run, iter([_dataset(pool[k])]), run.traffic["flush_every"]))
    return dict(index=k, n=len(pool[k]["traj_ids"]), t0=t0, t1=time.perf_counter(), out=out)


def rows(rec):
    return common.rows_from_table(rec["out"])


def tally(run):
    return common.tally(run, rows)


#: the per-row arrays of a tiling that :func:`portbench.checks.check_fits` reads
ROW_KEYS = ("count", "mjd", "ra", "dec", "sigma_ra", "sigma_dec", "station", "seed_elements", "seed_epoch")
#: the escalated rows' numbers are the fits' numbers under this prefix
PREFIX = "escalated_"


def check_escalated(run, replace=None):
    """Every escalated row of the window (each record's rows that the lean
    stage alone left unconverged at set-up) against the reference,
    corrected from the fixtures' stored orbits
    (:func:`portbench.checks.check_fits` over those rows alone) under the
    settings of the stage that refits them, the last.  A refit that
    patched nothing leaves them unconverged; one that patched in wrong
    orbits leaves them away from the reference's.  Returns the numbers
    ``check.escalated.limits`` names, none when no row escalates."""
    ck = run.traffic["check"]
    pool, picks = run.state["pool"], run.state["escalated"]
    blocks = []
    for r in run.records:
        pick = picks[r["index"]]
        if len(pick):
            d = pool[r["index"]]
            blocks.append(({k: v[pick] for k, v in rows(r).items()},
                           dict({k: d[k][pick] for k in ROW_KEYS}, stations=d["stations"])))
    if not blocks:
        return []
    stage = ([run.config] + run.config["escalation"]["stages"])[-1]
    limits = {k[len(PREFIX):]: v for k, v in ck["escalated"]["limits"].items()}
    view = SimpleNamespace(seed=run.seed, config=dict(run.config, correction=stage["correction"]),
                           traffic=dict(run.traffic, check=dict(ck, sample=sum(len(b[0]["present"]) for b in blocks),
                                                                limits=limits)))
    return [dict(n, name=PREFIX + n["name"]) for n in checks.check_fits(view, blocks, truth=False, replace=replace)]


def check(run, replace=None):
    """The sampled rows against the reference, corrected from the fixtures'
    stored orbits under the lean stage's settings
    (:func:`portbench.checks.check_fits`), the reference's own IOD and
    correction against the program's (:mod:`portbench.iod_check`), then
    every escalated row (:func:`check_escalated`)."""
    pool = run.state["pool"]
    blocks = [(rows(r), pool[r["index"]]) for r in run.records]
    return (checks.check_fits(run, blocks, truth=False, replace=replace) + iod_check.check(run, blocks, replace=replace)
            + check_escalated(run, replace=replace))
