"""The check that decides ``correct``: what the window produced, a sample
of it drawn from the seed, against the plain reference.

Each number has an upper limit, set in the traffic file's ``check`` from
the readings of sound runs and of the lower-precision control (see
``PERF.md``).  A number is ``{"name", "value", "limit", "ok"}``.

Fits.  For each sampled trajectory the reference (float64, plain
PyTorch, its own observer positions) runs the correction twice: from the
start the program had (the seed; for an unseeded fit, the true orbit the
traffic drew, standing in for the IOD) to say whether it converges, and
from the program's final orbit to find the least-squares optimum with its
outlier selection, covariance and RMS.  A fit counts when it converged
with a normalised RMS of at most ``rms_max``.  Compared: rows without a
result; the share whose fit the reference makes and the program does not;
among the program's fits, the share the reference does not confirm; the
``quantile`` (from the traffic file) over those fits of the gap to the
optimum in the orbit's standard deviations, of the relative gap of the
1-sigma uncertainties and of the normalised RMS (a quantile and not the
largest: a fit that ends by stagnating along a flat valley ends at a point
that depends on its path, and a few in a hundred do); the share with
another count of active observations; for rows that fell back to
their IOD orbit, the relative gap of that orbit's RMS.

Propagation.  The sampled lanes are integrated by the reference (its own
Dormand-Prince 5(4) at a tolerance of 1e-13, the planets from the frozen
analytic ephemeris at every stage); compared: lanes without status 0, the
largest position and velocity gaps, and the largest gaps of the position
and of the velocity partials, each relative to the lane's largest partial
of its kind.
"""

import math

import numpy as np
import torch

from portbench.reference import lsq, nbody, observers
from portbench.traffic.synthetic import rng


def number(name, value, limit):
    value = float(value)
    return dict(name=name, value=value, limit=float(limit), ok=bool(value <= limit))


def sample_rows(run, sizes, k):
    """(block, row) pairs, ``k`` of them drawn from the seed over all rows."""
    total = int(sum(sizes))
    flat = np.sort(rng(run.seed, 9).choice(total, size=min(k, total), replace=False))
    starts = np.cumsum([0] + list(sizes[:-1]))
    blocks = np.searchsorted(starts, flat, side="right") - 1
    return list(zip(blocks.tolist(), (flat - starts[blocks]).tolist()))


def gather(blocks, picks):
    """Program rows and padded reference inputs of the picked rows."""
    prog = {k: np.stack([blocks[b][0][k][i] for b, i in picks]) for k in blocks[0][0]}
    datas = [blocks[b][1] for b, _ in picks]
    width = max(int(d["count"][i]) if "count" in d else d["mjd"].shape[1] for d, (_, i) in zip(datas, picks))
    R = len(picks)
    arr = {k: np.zeros((R, width)) for k in ("mjd", "ra", "dec", "sigma_ra", "sigma_dec")}
    valid = np.zeros((R, width), bool)
    station = np.zeros((R, width), np.int64)
    for r, (d, (_, i)) in enumerate(zip(datas, picks)):
        n = int(d["count"][i]) if "count" in d else d["mjd"].shape[1]
        for k in ("mjd", "ra", "dec"):
            arr[k][r, :n] = d[k][i, :n]
        arr["sigma_ra"][r, :n] = d.get("sigma_ra", d.get("sigma"))[i, :n]
        arr["sigma_dec"][r, :n] = d.get("sigma_dec", d.get("sigma"))[i, :n]
        if "station" in d:
            station[r, :n] = d["station"][i, :n]
        valid[r, :n] = True
        arr["mjd"][r, n:] = arr["mjd"][r, 0]
        arr["sigma_ra"][r, n:] = arr["sigma_dec"][r, n:] = 1.0
    return prog, datas, arr, valid, station


def reference_inputs(arr, valid, station, data0):
    mjd = torch.as_tensor(arr["mjd"])
    pos = observers.heliocentric(mjd, torch.as_tensor(station), data0.get("stations"))
    return lsq.Observations(mjd, *(torch.as_tensor(arr[k]) for k in ("ra", "dec", "sigma_ra", "sigma_dec")), pos,
                            torch.as_tensor(valid))


def starts(datas, picks, truth):
    """Each picked row's start: the truth for unseeded traffic, else the
    seed the program was given."""
    key = "elements" if truth else "seed_elements"
    ekey = "epoch" if truth else "seed_epoch"
    el = np.stack([d[key][i] for d, (_, i) in zip(datas, picks)])
    ep = np.array([d[ekey][i] for d, (_, i) in zip(datas, picks)])
    return torch.as_tensor(el), torch.as_tensor(ep)


def sigmas(cov):
    return np.sqrt(np.clip(np.diagonal(cov, axis1=-2, axis2=-1), 0, None))


def iod_rms(elements, epoch, obs):
    """The IOD's score of an orbit over its arc: sqrt(sum((cos(dec) dRA /
    sigma)^2 + (dDec / sigma)^2) / 2N) over the observations."""
    from portbench.reference.twobody import radec

    ra, dec = radec(elements, epoch, obs.mjd, obs.observer)
    dra = torch.remainder(obs.ra - ra, 2 * math.pi)
    dra = torch.where(dra > math.pi, dra - 2 * math.pi, dra)
    terms = (torch.cos(obs.dec) * dra / obs.sigma_ra) ** 2 + ((obs.dec - dec) / obs.sigma_dec) ** 2
    terms = torch.where(obs.valid, terms, 0.0)
    return torch.sqrt(terms.sum(-1) / (2 * obs.valid.sum(-1)))


def check_fits(run, blocks, truth, replace=None):
    """``blocks``: [(program rows, traffic data)] of the window's calls.
    ``replace``: a function (start elements, start epochs, observations,
    program rows) -> rows, put in the program's place for the sampled rows
    (the control).  Returns the numbers the traffic file has limits for."""
    ck = run.traffic["check"]
    picks = sample_rows(run, [len(b[0]["present"]) for b in blocks], ck["sample"])
    prog, datas, arr, valid, station = gather(blocks, picks)
    obs = reference_inputs(arr, valid, station, datas[0])
    cfg = run.config["correction"]
    x0, e0 = starts(datas, picks, truth)
    if replace is not None:
        prog = replace(x0, e0, obs, prog)
    values = {"missing_rows": int((~prog["present"]).sum())}
    # a fit counts when it converged consistently with its noise (a
    # correction that stagnates far from any fit also ends converged)
    rms_max = ck["rms_max"]
    ref0 = lsq.differential_correction(x0, e0, obs, cfg)
    ref_good = ((ref0["status"] == lsq.OK) & (ref0["rms"] <= rms_max)).numpy()
    good = prog["present"] & prog["converged"] & (prog["rms"] <= rms_max)
    values["lost_convergence"] = (ref_good & ~good).mean()
    idx = np.nonzero(good)[0]
    q = ck["quantile"]
    if len(idx):
        sub = obs.rows(torch.as_tensor(idx))
        x1 = torch.as_tensor(prog["elements"][idx])
        ref1 = lsq.differential_correction(x1, torch.as_tensor(prog["epoch"][idx]), sub, cfg)
        # a fit the reference does not confirm, or whose outlier selection
        # it does not repeat, is as far as a fit can be
        ok1 = ((ref1["status"] == lsq.OK) & (ref1["rms"] <= rms_max)).numpy()
        ok1 &= prog["n_active"][idx] == ref1["n_active"].numpy()
        cov = torch.where(torch.as_tensor(ok1)[:, None, None], ref1["covariance"], torch.eye(6, dtype=torch.float64))
        gap = np.where(ok1, lsq.mahalanobis(x1, ref1["elements"], cov).numpy(), np.inf)
        s_gap = np.where(ok1, np.abs(sigmas(prog["covariance"][idx]) / sigmas(cov.numpy()) - 1).max(1), np.inf)
        r_gap = np.where(ok1, np.abs(prog["rms"][idx] / ref1["rms"].numpy() - 1), np.inf)
        values.update(orbit_gap_sigma=np.quantile(gap, q), sigma_gap_rel=np.quantile(s_gap, q),
                      rms_gap_rel=np.quantile(r_gap, q))
    else:
        values.update(orbit_gap_sigma=np.inf, sigma_gap_rel=np.inf, rms_gap_rel=np.inf)
    fb = np.nonzero(prog["present"] & ~prog["converged"] & prog["iod_ok"] & np.isfinite(prog["iod_elements"]).all(1))[0]
    if len(fb):
        sub = obs.rows(torch.as_tensor(fb))
        r = iod_rms(torch.as_tensor(prog["iod_elements"][fb]), torch.as_tensor(prog["iod_epoch"][fb]), sub).numpy()
        values["iod_rms_gap_rel"] = np.abs(prog["iod_rms"][fb] / r - 1).max()
    # no row of the sample fell back to its IOD orbit: that number has
    # nothing to read
    return [number(k, values.get(k, np.inf), v) for k, v in ck["limits"].items()
            if k != "iod_rms_gap_rel" or k in values]


def check_propagation(run, lanes, result, replace=None):
    """``lanes``: the sampled lanes of the traffic (``elements``,
    ``epoch``, ``t1``); ``result``: the program's (position, velocity,
    d position / d elements, d velocity / d elements, status) of those
    lanes, numpy arrays.
    ``replace``: a function (elements, epochs, end epochs, bodies) ->
    result, put in the program's place (the control)."""
    lim = run.traffic["check"]["limits"]
    el, ep, t1 = (torch.as_tensor(lanes[k]) for k in ("elements", "epoch", "t1"))
    bodies = run.config["propagation"]["bodies"]
    pos, vel, dpos, dvel, status = result
    if replace is not None:
        pos, vel, dpos, dvel, status = replace(el, ep, t1, bodies)
    rp, rv, rj, rjv, _, done = (x.numpy() for x in nbody.propagate(el, ep, t1, bodies))
    L = len(t1)

    def partials_gap(prog, ref):
        return (np.abs(prog - ref).reshape(L, -1).max(1) / np.abs(ref).reshape(L, -1).max(1)).max()

    values = dict(bad_status=int((status != 0).sum()), position_gap_au=np.abs(pos - rp).max(),
                  velocity_gap_au_day=np.abs(vel - rv).max(), partials_gap_rel=partials_gap(dpos, rj),
                  velocity_partials_gap_rel=partials_gap(dvel, rjv), reference_unfinished=int((~done).sum()))
    return [number(k, values.get(k, np.inf), v) for k, v in lim.items()]
