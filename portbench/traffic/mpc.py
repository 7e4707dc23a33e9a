"""Catalogue refits at real cadence: real MPC 80-column astrometry, tiled.

The fixtures named by the configuration (real observations of real
objects, with their stations, catalogs and cadence) are read by this
module's own reader, weighted by the FCCT14 table, tiled round-robin to
``n_traj`` trajectories and re-noised at each observation's sigma (RA by
sigma / cos(dec), Dec by sigma), as ``bench.py:350-403`` builds its
real-cadence workload.  Each copy is seeded with its fixture's
stored orbit.  Epochs are UTC in the files and TT here (IERS leap
seconds, TT = TAI + 32.184 s).
"""

import json
import math
import os

import numpy as np

from portbench.traffic.synthetic import rng

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
ARCSEC = math.pi / 648000.0


def _load(name):
    with open(os.path.join(DATA, name), encoding="utf-8") as fh:
        return json.load(fh)


def utc_to_tt(mjd_utc):
    steps = np.array(_load("leap_seconds.json")["steps"])
    i = np.clip(np.searchsorted(steps[:, 0], mjd_utc, side="right") - 1, 0, len(steps) - 1)
    return mjd_utc + (steps[i, 1] + 32.184) / 86400.0


def _mjd_utc(year, month, day):
    """MJD of a Gregorian calendar date (day with its fraction), UTC."""
    a = (14 - month) // 12
    y, m = year + 4800 - a, month + 12 * a - 3
    jdn = int(day) + (153 * m + 2) // 5 + 365 * y + y // 4 - y // 100 + y // 400 - 32045
    return jdn - 2400001 + (day - int(day))


def read_mpc80(path):
    """Records of an MPC 80-column file: (MJD UTC, RA rad, Dec rad,
    station code, catalog flag), optical lines only (a satellite or
    roving observer's second line is skipped)."""
    out = []
    with open(path, encoding="utf-8", errors="replace") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if len(line) < 80 or line[14] in "svrR":
                continue
            y, m, d = line[15:32].split()
            h, mi, s = (float(x) for x in line[32:44].split())
            sign = -1.0 if line[44] == "-" else 1.0
            dd, dm, ds = (float(x) for x in line[45:56].split())
            out.append((_mjd_utc(int(y), int(m), float(d)), (h + mi / 60 + s / 3600) * math.pi / 12,
                        sign * (dd + dm / 60 + ds / 3600) * math.pi / 180, line[77:80], line[71]))
    return out


def fixtures(names):
    """Per fixture: arrays of its observations (TT epochs, angles, sigma,
    station code) and its stored seed orbit."""
    fc = _load("fcct14.json")
    seeds = _load("iod_seeds_analytic.json")
    bases = []
    for name in names:
        rec = read_mpc80(os.path.join(DATA, f"{name}.obs"))
        sig = [fc["station_catalog_arcsec"].get(f"{st} {cat}", fc["station_arcsec"].get(st, fc["default_arcsec"]))
               for _, _, _, st, cat in rec]
        (seed,) = seeds[name].values()
        bases.append(dict(mjd=utc_to_tt(np.array([r[0] for r in rec])), ra=np.array([r[1] for r in rec]),
                          dec=np.array([r[2] for r in rec]), sigma=np.array(sig) * ARCSEC,
                          station=[r[3] for r in rec], seed_elements=np.array(seed["equinoctial"]),
                          seed_epoch=float(seed["epoch"])))
    return bases


def tiling(seed, index, names, n_traj, noise_seed):
    """One dataset of ``n_traj`` trajectories: padded (T, N) arrays
    ``mjd``, ``ra``, ``dec``, ``sigma_ra``, ``sigma_dec``, ``station``
    (indices into ``stations``), ``count`` (T,), the seeds, the fixture
    each row copies (``pick``), and the station table.  The noise is drawn
    from ``noise_seed``, the order of the trajectories from ``seed``, so
    that every seed gets the same work."""
    bases = fixtures(names)
    table = _load("stations.json")["stations"]
    codes = sorted({c for b in bases for c in b["station"]})
    code_idx = {c: i for i, c in enumerate(codes)}
    stations = dict(codes=codes, longitude=np.array([table[c]["longitude_rad"] for c in codes]),
                    rho_cos_phi=np.array([table[c]["rho_cos_phi"] for c in codes]),
                    rho_sin_phi=np.array([table[c]["rho_sin_phi"] for c in codes]))
    width = max(len(b["mjd"]) for b in bases)
    pick = np.arange(n_traj) % len(bases)
    count = np.array([len(bases[p]["mjd"]) for p in pick])
    out = {k: np.zeros((n_traj, width)) for k in ("mjd", "ra", "dec", "sigma_ra", "sigma_dec")}
    out["station"] = np.zeros((n_traj, width), np.int64)
    for p, b in enumerate(bases):
        rows = pick == p
        n = len(b["mjd"])
        for k in ("mjd", "ra", "dec"):
            out[k][rows, :n] = b[k]
        out["sigma_ra"][rows, :n] = out["sigma_dec"][rows, :n] = b["sigma"]
        out["station"][rows, :n] = [code_idx[c] for c in b["station"]]
    valid = np.arange(width)[None, :] < count[:, None]
    gen = rng(noise_seed, 3, index)
    noise = gen.normal(0.0, 1.0, (2, int(count.sum())))
    out["ra"][valid] += noise[0] * out["sigma_ra"][valid] / np.cos(out["dec"][valid])
    out["dec"][valid] += noise[1] * out["sigma_dec"][valid]
    out["ra"][valid] = np.remainder(out["ra"][valid], 2 * math.pi)
    out.update(count=count, pick=pick, valid=valid, seed_elements=np.stack([bases[p]["seed_elements"] for p in pick]),
               seed_epoch=np.array([bases[p]["seed_epoch"] for p in pick]))
    order = rng(seed, 5, index).permutation(n_traj)
    out = {k: v[order] for k, v in out.items()}
    out["stations"] = stations
    return out
