"""The check of an unseeded fit's initial orbits: the reference's own
pipeline, Gauss's method then the correction, against the program's final
orbits.

For each sampled row (``check.iod.sample`` of them, drawn from the seed):

1. one well-spread triplet from the arc's 32-point uniform-with-edges
   downsample (the IOD's own downsample): its first, middle and last
   points, or on an arc of more than the IOD's widest triplet (150 days)
   the widest pair within it with the point nearest their middle between
   them (:func:`triplet`; a triplet over 2015AB's 1,981 days is no orbit
   Gauss's method can find);
2. the plain Gauss IOD on it (:mod:`portbench.reference.iod`), the
   candidate kept as Outfit keeps it, corrected first, then the least RMS
   over the whole arc;
3. that orbit carried by two-body motion to the program's epoch (so the two
   final orbits share it), a float64 pre-warm (guarded Newton steps with
   every observation active, until the step's norm falls under
   max(threshold, 1e-3) or stops halving, at most ``prewarm_max_iterations``:
   the rule of the program's mixed pre-warm, without its float32), then
   :func:`portbench.reference.lsq.differential_correction` under the
   configuration's correction settings.

A fit counts when converged with a normalised RMS of at most
``check.rms_max``.  Compared: ``ref_iod_lost``, the share of the rows whose
reference pipeline fits where the program's row does not; and the
``check.quantile`` of ``ref_iod_gap_sigma`` over the rows both fit, the
program's final orbit against the reference pipeline's in the reference's
standard deviations (a row whose outlier selection differs is as far as a
row can be).  A row where the reference's Gauss finds no orbit on its one
triplet is the reference's miss, counted in neither.
"""

import math

import numpy as np
import torch

from portbench import checks
from portbench.reference import iod, lsq
from portbench.reference.twobody import state

#: the IOD's triplet downsample (``max_obs_for_triplets`` of the lean stage)
DOWNSAMPLE = 32
#: the widest triplet the IOD forms, days (``IODParams.dt_max_triplet``)
SPAN_MAX = 150.0
#: a harmless orbit in the place of a row without one (its result unused)
STAND_IN = torch.tensor([2.5, 0.0, 0.0, 0.0, 0.0, 0.0], dtype=torch.float64)


def triplet(mjd, counts, m=DOWNSAMPLE, span_max=SPAN_MAX):
    """(R, 3) observation indices of one well-spread triplet per row, from
    the arc's ``m``-point uniform-with-edges downsample (every observation
    when the arc has at most ``m``): the widest pair of its points at most
    ``span_max`` days apart (the earliest such pair among equals), and
    between them the point nearest their mid-epoch.  On an arc of at most
    ``span_max`` days, its first, middle and last points."""
    mjd, counts = np.asarray(mjd), np.asarray(counts, np.int64)
    out = np.zeros((len(counts), 3), np.int64)
    for r, n in enumerate(counts):
        m_eff = min(n, m)
        keep = np.arange(m_eff) * (n - 1) // max(m_eff - 1, 1)
        t = mjd[r, keep]
        span = t[None, :] - t[:, None]
        ok = (span <= span_max) & (np.arange(m_eff)[None, :] >= np.arange(m_eff)[:, None] + 2)
        i, k = np.unravel_index(np.argmax(np.where(ok, span, -np.inf)), span.shape)
        j = i + 1 + np.argmin(np.abs(t[i + 1:k] - 0.5 * (t[i] + t[k])))
        out[r] = keep[[i, j, k]]
    return out


def gauss_orbits(obs, idx):
    """The reference Gauss orbit of each row on its triplet ``idx``, in
    float64: (equinoctial elements (R, 6), epoch (R,), found (R,))."""
    it = torch.as_tensor(idx)
    time, ra, dec = (torch.gather(x, 1, it) for x in (obs.mjd, obs.ra, obs.dec))
    pos = torch.gather(obs.observer, 1, it[..., None].expand(-1, -1, 3))
    cands = iod.gauss(time, ra, dec, pos)
    el = iod.candidate_elements(cands)
    R, M = el.shape[:2]
    finite = torch.isfinite(el).all(-1) & (el[..., 0] > 0)
    safe = torch.where(finite[..., None], el, STAND_IN)
    rms = checks.iod_rms(safe.reshape(R * M, 6), cands.epoch.reshape(R * M),
                         obs.rows(torch.arange(R).repeat_interleave(M))).reshape(R, M)
    rms = torch.where(finite, rms, torch.inf)
    best, found = iod.best_candidate(cands._replace(valid=cands.valid & finite), rms)
    pick = torch.arange(R)
    return el[pick, best], cands.epoch[pick, best], found


def carry(elements, epoch, to_epoch):
    """Two-body motion of ``elements`` (R, 6) from ``epoch`` to ``to_epoch``."""
    return iod.equinoctial(*state(elements, (to_epoch - epoch).to(elements.dtype)))


def prewarm(x, epoch, obs, cfg):
    """Guarded float64 Newton steps with every observation active, the
    program's mixed pre-warm rule (``lsq/loop.py:_prewarm_f32``)."""
    thr = max(cfg["convergence_threshold"], 1e-3)
    R = x.shape[0]
    prev = torch.full((R,), math.inf, dtype=torch.float64)
    done = ~torch.isfinite(x).all(-1)
    for it in range(cfg["prewarm_max_iterations"]):
        if done.all():
            break
        s = lsq.newton_step(x, epoch, obs, obs.valid, torch.float64)
        sane = s["inv_ok"] & torch.isfinite(s["norm"]) & ~lsq._bizarre(s["corrected"], cfg["orbital_limits"])
        adv = ~done & sane
        x = torch.where(adv[:, None], s["corrected"], x)
        plateau = (s["norm"] >= 0.5 * prev) & (it >= 2)
        done = done | ~sane | (adv & ((s["norm"] < thr) | plateau))
        prev = torch.where(adv, s["norm"], prev)
    return x


def check(run, blocks, replace=None):
    """``blocks``: [(program rows, traffic data)] of the window's calls;
    ``replace`` as in :func:`portbench.checks.check_fits`.  Returns the
    numbers ``check.iod.limits`` names."""
    ck = run.traffic["check"]
    ick = ck["iod"]
    picks = checks.sample_rows(run, [len(b[0]["present"]) for b in blocks], ick["sample"])
    prog, datas, arr, valid, station = checks.gather(blocks, picks)
    obs = checks.reference_inputs(arr, valid, station, datas[0])
    cfg = run.config["correction"]
    if replace is not None:
        prog = replace(*checks.starts(datas, picks, False), obs, prog)
    el, ep, found = gauss_orbits(obs, triplet(arr["mjd"], valid.sum(1)))
    p_epoch = torch.as_tensor(prog["epoch"])
    to = torch.where(torch.isfinite(p_epoch), p_epoch, ep)
    x0 = torch.where(found[:, None], carry(el, ep, to), el)
    ok0 = found & torch.isfinite(x0).all(-1)
    x0 = torch.where(ok0[:, None], x0, STAND_IN)
    ref = lsq.differential_correction(prewarm(x0, to, obs, cfg), to, obs, cfg)
    rms_max = ck["rms_max"]
    ref_good = (ok0 & (ref["status"] == lsq.OK) & (ref["rms"] <= rms_max)).numpy()
    good = prog["present"] & prog["converged"] & (prog["rms"] <= rms_max)
    values = {"ref_iod_lost": float((ref_good & ~good).mean())}
    both = np.nonzero(ref_good & good)[0]
    gap = np.full(len(both), np.inf)
    if len(both):
        sel = torch.as_tensor(both)
        same = prog["n_active"][both] == ref["n_active"][sel].numpy()
        g = lsq.mahalanobis(torch.as_tensor(prog["elements"][both]), ref["elements"][sel],
                            ref["covariance"][sel]).numpy()
        gap = np.where(same, g, np.inf)
    values["ref_iod_gap_sigma"] = float(np.quantile(gap, ck["quantile"])) if len(gap) else math.inf
    return [checks.number(k, values.get(k, math.inf), v) for k, v in ick["limits"].items()]
