#!/usr/bin/env python3
"""Why two mixed-precision fits of the same data, a float32 rounding apart,
end apart: the float32 Jacobians' error, the correction norm at every
Newton step, and the spread between the two fits, on the card and on the
CPU.

Run from the repository root (the card is used when one is present):

    python3 tools/torch_lsq/mixed_spread.py [--n 4096] [--n-cpu 1024]

On the real-cadence workload of ``chip_smoke.py`` phase 4 (the fixtures
2015AB, 8467 and 33803 tiled round-robin to ``--n`` trajectories, each
seeded with its fixture's orbit), with ``DifferentialCorrectionConfig(
precision="mixed")``:

1. the element Jacobians of the mixed loop (float32 beside a float64
   propagation) against float64 ones, at the elements of the loop's first
   step: the largest error per element relative to the largest float64
   partial of the row, the worst row of each fixture;
2. the sigma-weighted correction norm at every step of rows 1, 4, 7, 10
   (8467), 2 (33803) and 3 (2015AB), in the float32 pre-warm and in the
   float64 loop, then the same rows' float64 fit;
3. phase 14's debiasing: the observations shifted by the bias of its
   NSIDE-64 table and debiased (``apply_debias``), against the same data
   debiased on the host, both fitted in mixed precision: the rows off
   rtol 1e-7 / atol 1e-9 by fixture, the largest deviation in the 1-sigma
   uncertainties, the rows whose pre-warm output differs; and the
   host-debiased mixed fit against a second run of itself.

Steps 1 and 3 run on the card at ``--n`` trajectories and on the CPU at
``--n-cpu``; step 2 on each at its own size.
"""

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import outfit_tpu_torch.lsq.loop as loop  # noqa: E402
from outfit_tpu_torch import DifferentialCorrectionConfig, JPLEphem, fit_lsq  # noqa: E402
from outfit_tpu_torch.lsq.iteration import ObsArrays, observation_partials  # noqa: E402
from outfit_tpu_torch.observations.debias import DebiasTable  # noqa: E402

ROWS = [1, 4, 7, 10, 2, 3]
MIXED = DifferentialCorrectionConfig(precision="mixed")
F64 = DifferentialCorrectionConfig()


class Recorder:
    """Wraps ``loop.single_iteration`` and ``loop._prewarm_f32``: keeps the
    first float32-Jacobian step's inputs, the correction norms of ``ROWS``
    and the pre-warm outputs."""

    def __init__(self):
        self.step, self.prewarm = loop.single_iteration, loop._prewarm_f32
        self.first, self.norms, self.warm = None, [], []
        loop.single_iteration, loop._prewarm_f32 = self._step, self._prewarm

    def clear(self):
        self.first, self.norms, self.warm = None, [], []

    def _step(self, el, ep, sel, obs, free, prop=None, ephem=None, jac=None, **kw):
        if jac is not None and self.first is None:
            self.first = (el.clone(), ep.clone(), obs)
        res = self.step(el, ep, sel, obs, free, prop, ephem, jac, **kw)
        tag = "pre-warm" if el.dtype == torch.float32 else ("float32 J" if jac is not None else "float64")
        rows = [r for r in ROWS if r < el.shape[0]]
        self.norms.append((tag, res.correction_norm[rows].double().cpu().numpy()))
        return res

    def _prewarm(self, *a, **kw):
        out = self.prewarm(*a, **kw)
        self.warm.append(out[0].cpu().numpy())
        return out


def jacobian_error(rec, picks, dev):
    el, ep, obs = rec.first
    obs = ObsArrays(*[None if x is None else x.to(dev) for x in obs])
    el, ep = el.to(dev), ep.to(dev)
    lo = observation_partials(el, ep, obs, jacobian_dtype=torch.float32)
    hi = observation_partials(el, ep, obs)
    valid = obs.valid.cpu().numpy()[..., None]
    for name, i in (("d_ra", 2), ("d_dec", 3)):
        d_lo, d_hi = lo[i].cpu().numpy(), hi[i].cpu().numpy()
        err = np.abs(np.where(valid, d_lo - d_hi, 0)).max(axis=1) / np.abs(np.where(valid, d_hi, 0)).max(axis=1)
        for f, fixture in enumerate(cs.FIXTURES):
            worst = err[np.asarray(picks[: len(err)]) == f].max(axis=0)
            print(f"  {dev} {name} {fixture}: largest relative error per element "
                  f"{np.array2string(worst, precision=2)}", flush=True)


def print_norms(rec, res, ds, tag):
    print(f"  {tag}, rows {ROWS}:", flush=True)
    for step, norms in rec.norms:
        print(f"    {step:9s} {np.array2string(norms, precision=3)}", flush=True)
    print(f"    status {[res[ds.traj_ids[r]].status for r in ROWS]}, Newton iterations "
          f"{[res[ds.traj_ids[r]].total_newton_iterations for r in ROWS]}", flush=True)


def spread(a, b, picks, tag, warm=None):
    rows = [t for t in a if a[t].status == 1 and b[t].status == 1]
    dev = {t: np.abs(a[t].equinoctial - b[t].equinoctial) for t in rows}
    off = [t for t in rows if not np.all(dev[t] <= 1e-9 + 1e-7 * np.abs(b[t].equinoctial))]
    by = {f: sum(cs.FIXTURES[picks[int(t[1:])]] == f for t in off) for f in cs.FIXTURES}
    sigma = max((float((dev[t] / b[t].uncertainties).max()) for t in rows), default=0.0)
    line = f"  {tag}: {len(off)} of {len(rows)} rows off rtol 1e-7 / atol 1e-9 {by}; at most {sigma!r} sigma"
    if warm is not None:
        line += f"; pre-warm output differs on {int((np.abs(warm[0] - warm[1]).max(axis=1) > 0).sum())} rows"
    print(line, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=cs.N_TRAJ)
    ap.add_argument("--n-cpu", type=int, default=1024)
    args = ap.parse_args()
    card = None
    if torch.cuda.is_available():
        card = "cuda"
        cs.phase_device()
    eph = JPLEphem.analytic(*cs.SPAN)
    ds, picks = cs.real_cadence_dataset(args.n)
    seeds = cs.seeds_for(ds, picks)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bias.dat")
        cs.write_debias_table(path, sorted(set(ds.catalog) - {" "}))
        table = DebiasTable.load(path)
    b_ra, b_dec = table.bias_radians(ds.ra, ds.dec, ds.mjd_tt, ds.catalog)
    shifted = dataclasses.replace(ds, ra=ds.ra + b_ra, dec=ds.dec + b_dec)
    shifted.apply_debias(table)
    clean = dataclasses.replace(ds, ra=shifted.ra - shifted.bias_ra, dec=shifted.dec - shifted.bias_dec)
    rec = Recorder()
    results = {}
    for dev, n in ([(card, args.n)] if card else []) + [("cpu", min(args.n, args.n_cpu))]:
        d, s = cs.head(clean, n), cs.head(shifted, n)
        s.bias_ra, s.bias_dec = shifted.bias_ra[: len(s)].copy(), shifted.bias_dec[: len(s)].copy()
        print(f"== {dev}, {n} trajectories", flush=True)
        rec.clear()
        a = fit_lsq(d, eph, config=MIXED, initial_orbits=seeds, device=dev)
        print_norms(rec, a, d, "1-2. host-debiased data, mixed")
        jacobian_error(rec, picks, dev)
        rec.clear()
        print_norms(rec, fit_lsq(d, eph, config=F64, initial_orbits=seeds, device=dev), d,
                    "2. host-debiased data, float64")
        rec.clear()
        again = fit_lsq(d, eph, config=MIXED, initial_orbits=seeds, device=dev)
        b = fit_lsq(s, eph, config=MIXED, initial_orbits=seeds, device=dev)
        spread(again, a, picks, "3. host-debiased mixed, run again")
        spread(b, a, picks, "3. debiased by the table against host-debiased, mixed", rec.warm)
        results[dev] = a
    if card:
        cpu = results["cpu"]
        spread({t: results[card][t] for t in cpu}, cpu, picks, "host-debiased mixed, card against CPU")


if __name__ == "__main__":
    main()
