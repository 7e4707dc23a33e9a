"""``propagate_nbody`` of one dataset's worth of orbits to a month ahead,
with the state transition matrix: the "predict next month, with
covariance" step of the survey service.

Traffic file keys: ``lanes`` (``n_lanes`` and the end epochs' range in
days after the epoch), ``check``.  Every call propagates the same lanes;
a call ends when its results are on the host."""

import time

import numpy as np

from portbench import checks
from portbench.drivers import common
from portbench.traffic import synthetic


def setup(run):
    import torch

    from outfit_tpu_torch import NBodyConfig
    from outfit_tpu_torch.elements.types import EquinoctialElements
    from outfit_tpu_torch.ephem.bodies import Body

    p = dict(run.config["population"], **run.traffic["lanes"])
    lanes = synthetic.lanes(run.seed, p)
    prop = run.config["propagation"]
    names = {"sun": Body.SUN, "mercury": Body.MERCURY_BARY, "venus": Body.VENUS_BARY, "emb": Body.EMB,
             "mars": Body.MARS_BARY, "jupiter": Body.JUPITER_BARY, "saturn": Body.SATURN_BARY,
             "uranus": Body.URANUS_BARY, "neptune": Body.NEPTUNE_BARY, "pluto": Body.PLUTO_BARY}
    cfg = NBodyConfig(perturbing_bodies=tuple(int(names[b]) for b in prop["bodies"]), abs_tol=prop["abs_tol"],
                      rel_tol=prop["rel_tol"], max_steps=prop["max_steps"],
                      frozen_perturbers=prop["frozen_perturbers"])
    dev = run.devices[0]
    f64 = dict(dtype=torch.float64, device=dev)
    eq = EquinoctialElements(torch.as_tensor(lanes["epoch"], **f64),
                             *(torch.as_tensor(lanes["elements"][:, j], **f64) for j in range(6)))
    return dict(eph=common.ephemeris(run), lanes=lanes, eq=eq, t1=torch.as_tensor(lanes["t1"], **f64), cfg=cfg)


def call(run, i):
    from outfit_tpu_torch import propagate_nbody

    s = run.state
    t0 = time.perf_counter()
    res = propagate_nbody(s["eq"], s["t1"], s["eph"], s["cfg"], device=run.devices[0])
    out = tuple(t.cpu().numpy() for t in (res.position, res.velocity, res.dpos_delem, res.dvel_delem, res.status))
    return dict(n=len(s["lanes"]["t1"]), t0=t0, t1=time.perf_counter(), out=out)


def window(run, deadline):
    records = []
    while time.perf_counter() < deadline:
        records.append(call(run, len(records)))
    return records


def tally(run):
    for r in run.records:
        r["done"] = int((r["out"][4] == 0).sum())
    n = sum(r["n"] for r in run.records)
    return n, n - sum(r["done"] for r in run.records)


def check(run, replace=None):
    """A sample of (call, lane) pairs drawn from the seed over the window."""
    lanes = run.state["lanes"]
    n = len(lanes["t1"])
    picks = checks.sample_rows(run, [n] * len(run.records), run.traffic["check"]["sample"])
    idx = np.array([i for _, i in picks])
    sub = {k: v[idx] for k, v in lanes.items()}
    out = tuple(np.stack([run.records[b]["out"][k][i] for b, i in picks]) for k in range(5))
    return checks.check_propagation(run, sub, out, replace=replace)
