"""``fit_lsq(..., initial_orbits=seeds)`` on fresh tilings of real
astrometry: the catalogue refit, which bypasses the IOD.

Traffic file keys: ``pool`` (distinct tilings built at set-up, used in
turn), ``population_seed`` (their noise; ``--seed`` orders their rows),
``devices`` (optional: ``"all"`` hands the program ``device=None``, its
default, which spreads each fit over every visible card; without it the
fit runs on the cell's first card), ``check``.  Each call is one tiling,
handed to the program as a fresh ``ObsDataset`` with its seeds."""

import time

import numpy as np

from portbench import checks
from portbench.drivers import common
from portbench.traffic import mpc


def setup(run):
    from outfit_tpu_torch import FitResult, Observer

    obs = run.config["observations"]
    n_traj = run.traffic.get("sizes", {}).get("n_traj", obs["n_traj"])
    pool = []
    for i in range(run.traffic["pool"]):
        d = mpc.tiling(run.seed, i, obs["fixtures"], n_traj, run.traffic["population_seed"])
        st = d["stations"]
        d["observers"] = [Observer.from_parallax(st["longitude"][k], st["rho_cos_phi"][k], st["rho_sin_phi"][k],
                                                 code=c) for k, c in enumerate(st["codes"])]
        d["traj_ids"] = [f"R{i:02d}_{t:06d}" for t in range(n_traj)]
        d["seeds"] = {tid: FitResult(tid, ok=True, rms=0.0, epoch=float(d["seed_epoch"][t]), kind=0,
                                     elements=None, equinoctial=d["seed_elements"][t].copy())
                      for t, tid in enumerate(d["traj_ids"])}
        pool.append(d)
    iod, cfg = common.settings(run.config)
    return dict(eph=common.ephemeris(run), pool=pool, iod=iod, cfg=cfg)


def _dataset(d):
    v = d["valid"]
    ds = common.dataset(d["mjd"][v], d["ra"][v], d["dec"][v], d["sigma_ra"][v], d["sigma_dec"][v],
                        np.repeat(np.arange(len(d["count"]), dtype=np.int64), d["count"]), d["station"][v],
                        d["observers"], "")
    ds.traj_ids = list(d["traj_ids"])
    return ds


def call(run, i):
    from outfit_tpu_torch import fit_lsq

    s = run.state
    k = max(i, 0) % len(s["pool"])
    d = s["pool"][k]
    t0 = time.perf_counter()
    device = None if run.traffic.get("devices") == "all" else run.devices[0]
    res = fit_lsq(_dataset(d), s["eph"], s["iod"], s["cfg"], initial_orbits=d["seeds"], device=device)
    return dict(index=k, n=len(d["traj_ids"]), t0=t0, t1=time.perf_counter(), out=res)


def window(run, deadline):
    records = []
    while time.perf_counter() < deadline:
        records.append(call(run, len(records)))
    return records


def rows(run, rec):
    return common.rows_from_dict(rec["out"], run.state["pool"][rec["index"]]["traj_ids"])


def tally(run):
    return common.tally(run, lambda rec: rows(run, rec))


def check(run, replace=None):
    pool = run.state["pool"]
    return checks.check_fits(run, [(rows(run, r), pool[r["index"]]) for r in run.records], truth=False,
                             replace=replace)
