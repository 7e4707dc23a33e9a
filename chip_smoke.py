#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 (no JAX
needed):

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero and prints no
``ok`` line):

1. device: a CUDA card must be present; prints the torch and CUDA versions
   and ``nvidia-smi``'s name and power limit of the card;
2. build: compiles the Chebyshev kernel (``outfit_tpu_torch/csrc``) with
   nvcc and prints the seconds it took;
3. kernel against its plain PyTorch version on the card, at the shapes of
   the fitting path below: the EMB and Moon tables at the observer cache's
   query count and at 37 queries, and the 10-channel frame table of the
   dataset; max deviation against the JAX package's bar for its Pallas
   kernel, and median times (CUDA events, 20 runs) of both;
4. the seeded least-squares path at real size: the real-cadence workload
   (the fixtures 2015AB, 8467 and 33803 tiled round-robin to 4096
   trajectories, re-noised with ``default_rng(0)`` at the catalog sigma),
   each copy seeded with its base fixture's orbit from
   tests/data/iod_seeds_analytic.json, through
   ``outfit_tpu_torch.fit_lsq(..., initial_orbits=seeds, device="cuda")``
   once cold and once warm; the kernel's launch counts of the cold run must
   show both call sites;
5. card against CPU on the first 64 trajectories of the same dataset;
6. the unseeded path (Gauss IOD, then the correction) at the JAX bench's
   synthetic size: 8192 trajectories of 12 geocentric observations
   (``bench.py:406-470``, built with the port's own propagation and
   apparent positions, sigma 2.4e-6 rad, ``default_rng(0)``), through
   ``outfit_tpu_torch.fit_lsq(ds, eph, IODParams(n_noise_realizations=3,
   newton_max_it=20, max_triplets=2), DifferentialCorrectionConfig(
   divergence_grace_iterations=2, max_newton_iterations=4), seed=7,
   device="cuda")``: 65,536 IOD lanes of 3 candidates;
7. the unseeded path on phase 4's real-cadence dataset with the bench's
   "rich" profile (``IODParams(n_noise_realizations=0, newton_max_it=20,
   max_triplets=16, max_obs_for_triplets=48)``, default correction):
   65,536 lanes at up to 129 observations, through the enumerator's
   downsampling branch.

8. the JAX bench's headline profile in mixed precision on phase 6's
   dataset: ``IODParams(n_noise_realizations=3, precision="mixed",
   newton_max_it=20, max_triplets=2)``, ``DifferentialCorrectionConfig(
   divergence_grace_iterations=2, precision="mixed",
   max_newton_iterations=4, prewarm_max_iterations=16)``, seed 7; its
   converged fraction and warm wall beside phase 6's float64 ones, card
   against CPU on 64 trajectories at seed grade, and the results with TF32
   matmuls allowed and not (identical);
9. ``fit_lsq_stream`` over three synthetic 8192 x 12 datasets
   (``default_rng`` seeds 400-402, as ``bench.py:885-888``) with phase 8's
   profile: the default mode, cold and warm (each dataset bitwise equal to
   a sequential ``fit_lsq``), and ``slim_fetch=True, as_table=True,
   minimal_fetch=True`` (the float32-rounding contract); stream and
   sequential fits/s;
10. ``fit_lsq_stream_escalating`` over three real-cadence 4096 datasets
   (seeds 101-103) with the bench's stages ``[(lean, lean_cfg), (rich,
   cfg)]`` (``bench.py:509-556``, mixed precision), ``flush_every=3``,
   ``depth=3``: the lean tier's converged fraction alone and after the
   refit (cold and warm), fits/s; every row the lean tier did not converge
   must carry the rich stage's result (called by hand on the same rows),
   every other row its lean result, and ``fit_lsq_escalating`` on the
   first dataset must equal its stages called by hand, row by row.

Phases 6 to 10 each run one cold and one warm pass (results must agree),
print the outcome histogram and require the kernel at both sites in the
pass the counts were reset for; phases 6 and 7 also count the host syncs
of a warm fit, profile a warm fit split into its IOD and correction
stages, and hold card against CPU on the first 64 trajectories.

The line before the last is ``{"kernels": [...]}`` (launches summed over
phases 4 and 6 to 10); the last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEEDS = os.path.join(HERE, "tests", "data", "iod_seeds_analytic.json")
FIXTURES = ("2015AB", "8467", "33803")
N_TRAJ = 4096
N_CHECK = 64
#: phase 8, mixed precision card against CPU on N_CHECK rows: the most IOD
#: winner changes, same-winner rows with another LSQ outcome, and
#: same-winner rows off the same orbit; the element spread inside one nRMS
#: basin (normalised as :func:`orbit_deviation` does; mean longitude in
#: rad).  Read over 8 fit seeds x 4 windows of 64 rows on an H100, maxima
#: 19, 3, 6 and 3.5e-3, 8.1e-5 (PERF.md §6)
MAX_WINNER_CHANGES, MAX_OUTCOME_CHANGES, MAX_MOVED = 24, 4, 8
ELEMENT_SPREAD, LAMBDA_SPREAD = 1e-2, 1e-3
SPAN = (53500.0, 61500.0)
#: phase 6: the JAX bench's synthetic workload
N_SYNTH, N_SYNTH_OBS, SYNTH_SIGMA = 8192, 12, 2.4e-6
#: card against CPU: IOD elements and RMS (LSQ elements at rtol 1e-6 / atol 1e-9)
IOD_RTOL = 1e-8
#: the JAX package's bar for its Pallas kernel (tests/test_ephem.py)
POS_ATOL, VEL_ATOL = 1e-15, 1e-16
#: frame-table entries: rotation-matrix entries and the equation of the equinoxes
FRAME_ATOL = 1e-15
KERNEL_SRC = "outfit_tpu_torch/csrc/chebyshev.cuh"
REPLACES = "outfit_tpu/ephem/pallas_kernel.py:123"


def _log(msg):
    print(msg, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    _log(smi)
    return torch.device("cuda")


def phase_build():
    from outfit_tpu_torch.ephem import chebyshev_cuda

    t = time.perf_counter()
    path, report = chebyshev_cuda.build()
    _log(f"build: {time.perf_counter() - t:.2f} s -> {os.path.relpath(path, HERE)}")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            _log("  " + line.strip())


def real_cadence_dataset(n_traj, seed=0):
    """bench.py's real-cadence workload, built with the port's host layer:
    the real fixtures tiled round-robin, FCCT14 sigmas, fresh noise."""
    import numpy as np

    from outfit_tpu_torch import ErrorModel, ObsDataset

    bases = []
    for name in FIXTURES:
        ds = ObsDataset.from_mpc_80_col(os.path.join(HERE, "tests", "data", f"{name}.obs"))
        ds.apply_error_model(ErrorModel.fcct14())
        bases.append(ds)
    rng = np.random.default_rng(seed)
    out = ObsDataset()
    counts = np.array([len(b.mjd_tt) for b in bases])
    picks = np.arange(n_traj) % len(bases)
    total = int(counts[picks].sum())
    for f in ("mjd_tt", "ra", "dec", "ra_error", "dec_error", "mag", "catalog"):
        setattr(out, f, np.concatenate([getattr(bases[p], f) for p in picks]))
    obs_off = np.cumsum([0] + [len(b.observers) for b in bases[:-1]])
    out.observers = [o for b in bases for o in b.observers]
    out.observer_index = np.concatenate([bases[p].observer_index + obs_off[p] for p in picks])
    out.traj_index = np.repeat(np.arange(n_traj, dtype=np.int64), counts[picks])
    out.traj_ids = [f"R{i:06d}" for i in range(n_traj)]
    out.ra = out.ra + rng.normal(0, 1, total) * out.ra_error / np.cos(out.dec)
    out.dec = out.dec + rng.normal(0, 1, total) * out.dec_error
    return out, picks


def head(ds, n_traj):
    """The first ``n_traj`` trajectories of a dataset stored trajectory by
    trajectory (as ``real_cadence_dataset`` stores it)."""
    from outfit_tpu_torch import ObsDataset

    k = int((ds.traj_index < n_traj).sum())
    out = ObsDataset()
    for f in ("mjd_tt", "ra", "dec", "ra_error", "dec_error", "mag", "catalog",
              "traj_index", "observer_index"):
        setattr(out, f, getattr(ds, f)[:k].copy())
    out.traj_ids = ds.traj_ids[:n_traj]
    out.observers = list(ds.observers)
    return out


def seeds_for(ds, picks):
    import numpy as np

    from outfit_tpu_torch import FitResult

    with open(SEEDS, encoding="utf-8") as fh:
        stored = json.load(fh)
    base = []
    for name in FIXTURES:
        (row,) = stored[name].values()
        base.append(row)
    seeds = {}
    for tid, p in zip(ds.traj_ids, picks):
        row = dict(base[p], traj_id=tid)
        seeds[tid] = FitResult(**{k: (np.array(v) if isinstance(v, list) else v) for k, v in row.items()})
    return seeds


def _median_ms(fn, runs=20):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernel_check(dev, eph, ds):
    """Kernel against its plain version at the fitting path's shapes."""
    import numpy as np
    import torch

    from outfit_tpu_torch.ephem.bodies import Body
    from outfit_tpu_torch.ephem.chebyshev import interpolate_body, interpolate_body_plain
    from outfit_tpu_torch.observer.cache import _frame_interp, _frame_interp_plain, _frame_table, frame_granules

    # the observer cache's queries: the epochs padded to a power of two with
    # the first epoch repeated (observer/cache.py)
    n = len(ds.mjd_tt)
    nb = 8
    while nb < n:
        nb *= 2
    mjd_np = np.concatenate([ds.mjd_tt, np.full(nb - n, ds.mjd_tt[0])])
    mjd = torch.as_tensor(mjd_np, dtype=torch.float64, device=dev)
    eph_d = eph.to(dev)
    rows = {}
    body_err = 0.0
    for body in (Body.EMB, Body.MOON):
        table = eph_d.tables[body]
        for q in (mjd, mjd[:37].contiguous()):
            p, v = interpolate_body(table, q)
            p0, v0 = interpolate_body_plain(table, q)
            ep = (p - p0).abs().max().item()
            evel = (v - v0).abs().max().item()
            _log(f"kernel body {body.name:4s} N={q.shape[0]:7d}: max|dpos| {ep!r} AU, max|dvel| {evel!r} AU/day")
            if not (ep <= POS_ATOL and evel <= VEL_ATOL):
                raise AssertionError(f"body kernel deviates from its plain version: {ep!r}, {evel!r}")
            body_err = max(body_err, ep, evel)
        ms = _median_ms(lambda: interpolate_body(table, mjd))
        plain_ms = _median_ms(lambda: interpolate_body_plain(table, mjd))
        _log(f"  {body.name} N={nb}: kernel {ms!r} ms, plain {plain_ms!r} ms (median of 20)")
        rows[body] = (ms, plain_ms)

    n_gran, gran, t0 = frame_granules(ds.mjd_tt)
    coeffs = _frame_table(t0, gran, n_gran, dev)
    frame_err = 0.0
    for q in (mjd, mjd[:37].contiguous()):
        m, e = _frame_interp(coeffs, q, t0, gran)
        m0, e0 = _frame_interp_plain(coeffs, q, t0, gran)
        err = max((m - m0).abs().max().item(), (e - e0).abs().max().item())
        _log(f"kernel frame G={n_gran} N={q.shape[0]:7d}: max|d| {err!r}")
        if not err <= FRAME_ATOL:
            raise AssertionError(f"frame kernel deviates from its plain version: {err!r}")
        frame_err = max(frame_err, err)
    f_ms = _median_ms(lambda: _frame_interp(coeffs, mjd, t0, gran))
    f_plain = _median_ms(lambda: _frame_interp_plain(coeffs, mjd, t0, gran))
    _log(f"  frame N={nb}: kernel {f_ms!r} ms, plain {f_plain!r} ms (median of 20)")
    return {
        "chebyshev_body": dict(err=body_err, ms=rows[Body.EMB][0], plain_ms=rows[Body.EMB][1]),
        "chebyshev_frame": dict(err=frame_err, ms=f_ms, plain_ms=f_plain),
    }


def _check_results(res, ds):
    import numpy as np

    assert list(res) == ds.traj_ids, "one result per trajectory, in dataset order"
    for tid, r in res.items():
        if not r.ok:
            raise AssertionError(f"{tid}: not ok ({r.error})")
        assert r.equinoctial.shape == (6,) and np.isfinite(r.equinoctial).all(), tid
        if not r.fell_back_to_iod:
            c = r.covariance
            assert c.shape == (6, 6) and np.isfinite(c).all() and (c == c.T).all(), tid
            assert (np.diag(c) > 0).all() and np.isfinite(r.normalised_rms), tid


def phase_slice(dev, eph, ds, picks):
    import numpy as np
    import torch

    from outfit_tpu_torch import DifferentialCorrectionConfig, fit_lsq
    from outfit_tpu_torch.ephem import chebyshev_cuda

    seeds = seeds_for(ds, picks)
    _log(f"slice: {len(ds.traj_ids)} trajectories, {len(ds.mjd_tt)} observations "
         f"(mean {len(ds.mjd_tt) / len(ds.traj_ids):.2f} per trajectory)")
    cfg = DifferentialCorrectionConfig()
    chebyshev_cuda.reset_launch_counts()
    t = time.perf_counter()
    res = fit_lsq(ds, eph, config=cfg, initial_orbits=seeds, device=dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t
    launches = dict(chebyshev_cuda.launches)
    t = time.perf_counter()
    res_w = fit_lsq(ds, eph, config=cfg, initial_orbits=seeds, device=dev)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t
    _log(f"slice wall: cold {cold!r} s, warm {warm!r} s; kernel launches in the cold run {launches}")
    if not (launches["body"] > 0 and launches["frame"] > 0):
        raise AssertionError(f"the fitting path did not launch the kernel at both sites: {launches}")
    _check_results(res, ds)
    status = np.array([r.status for r in res.values()])
    fell = sum(r.fell_back_to_iod for r in res.values())
    hist = {int(k): int(v) for k, v in zip(*np.unique(status, return_counts=True))}
    _log(f"status histogram {hist}; converged {int((status == 1).sum())}/{len(status)}; "
         f"IOD fallback {fell}")
    for tid in ds.traj_ids:
        a, b = res[tid], res_w[tid]
        if a.status != b.status or not np.array_equal(a.equinoctial, b.equinoctial):
            raise AssertionError(f"{tid}: cold and warm runs differ")
    profile_warm(dev, eph, ds, seeds, cfg)
    return launches, cold, warm, hist


def profile_warm(dev, eph, ds, seeds, cfg):
    """Where a warm fit's time goes: the observer cache build alone, then
    one fit under torch.profiler (device busy share and the kernels that
    take the most device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from outfit_tpu_torch import fit_lsq
    from outfit_tpu_torch.observer.cache import ObserverCache

    t = time.perf_counter()
    ObserverCache.build(ds, eph, device=dev)
    torch.cuda.synchronize()
    _log(f"observer cache build (warm): {time.perf_counter() - t!r} s")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fit_lsq(ds, eph, config=cfg, initial_orbits=seeds, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # the device's own events only (the operators that launched them carry
    # the same time again)
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    _log(f"profiled warm fit: wall {wall!r} s, device busy {busy_us / 1e6!r} s "
         f"({100.0 * busy_us / 1e6 / wall:.1f} % of wall), {launches} kernels and copies")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        _log(f"  {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:6d}  {e.key[:90]}")


def phase_cross_check(dev, eph, ds, picks):
    import numpy as np

    from outfit_tpu_torch import DifferentialCorrectionConfig, fit_lsq

    sub = head(ds, N_CHECK)
    seeds = seeds_for(sub, picks[:N_CHECK])
    cfg = DifferentialCorrectionConfig()
    rg = fit_lsq(sub, eph, config=cfg, initial_orbits=seeds, device=dev)
    rc = fit_lsq(head(ds, N_CHECK), eph, config=cfg, initial_orbits=seeds, device="cpu")
    worst = 0.0
    for tid in sub.traj_ids:
        a, b = rc[tid], rg[tid]
        if (a.status, a.fell_back_to_iod, a.n_active_obs) != (b.status, b.fell_back_to_iod, b.n_active_obs):
            raise AssertionError(f"{tid}: card and CPU disagree: {a.status} vs {b.status}")
        np.testing.assert_allclose(b.equinoctial, a.equinoctial, rtol=1e-6, atol=1e-9, err_msg=tid)
        worst = max(worst, float(np.max(np.abs(b.equinoctial - a.equinoctial))))
    _log(f"card vs CPU, {N_CHECK} trajectories: same statuses; max |d elements| {worst!r}")


def synthetic_dataset(n_traj, n_obs, eph, seed=0):
    """bench.py's synthetic workload (``bench.py:406-470``), built with the
    port: random bound orbits observed from the geocenter with the same
    ephemeris the fit uses."""
    import numpy as np
    import torch

    from outfit_tpu_torch import ObsDataset
    from outfit_tpu_torch.constants import ROT_ECLMJ2000_TO_EQUMJ2000
    from outfit_tpu_torch.elements.twobody import propagate_twobody
    from outfit_tpu_torch.elements.types import EquinoctialElements, KeplerianElements, keplerian_to_equinoctial
    from outfit_tpu_torch.iod.scoring import apparent_radec
    from outfit_tpu_torch.observations.observatories import Observer
    from outfit_tpu_torch.utils.linalg import rotate3

    rng = np.random.default_rng(seed)
    T = n_traj
    kep = KeplerianElements(*(torch.as_tensor(x, dtype=torch.float64) for x in (
        np.full(T, 57000.0), rng.uniform(1.2, 3.5, T), rng.uniform(0.0, 0.35, T), rng.uniform(0.0, 0.6, T),
        rng.uniform(0, 2 * np.pi, T), rng.uniform(0, 2 * np.pi, T), rng.uniform(0, 2 * np.pi, T),
    )))
    omjd = 57000.0 + np.sort(rng.uniform(0, 40, (T, n_obs)), axis=1)
    eq = keplerian_to_equinoctial(kep)
    st = propagate_twobody(
        EquinoctialElements(*(f[:, None] for f in eq)), 57000.0, torch.as_tensor(omjd), compute_derivatives=False
    )
    helio, _ = eph.earth_ephemeris(torch.as_tensor(omjd.ravel()))
    ra, dec = apparent_radec(
        rotate3(ROT_ECLMJ2000_TO_EQUMJ2000, st.position), rotate3(ROT_ECLMJ2000_TO_EQUMJ2000, st.velocity),
        helio.reshape(T, n_obs, 3),
    )
    ra = ra.numpy() + rng.normal(0, SYNTH_SIGMA, (T, n_obs))
    dec = dec.numpy() + rng.normal(0, SYNTH_SIGMA, (T, n_obs))

    ds = ObsDataset()
    ds.mjd_tt = omjd.ravel()
    ds.ra = ra.ravel()
    ds.dec = dec.ravel()
    ds.ra_error = np.full(T * n_obs, SYNTH_SIGMA)
    ds.dec_error = np.full(T * n_obs, SYNTH_SIGMA)
    ds.traj_index = np.repeat(np.arange(T, dtype=np.int64), n_obs)
    ds.observer_index = np.zeros(T * n_obs, np.int64)
    ds.traj_ids = [f"S{i:06d}" for i in range(T)]
    ds.observers = [Observer.geocenter()]
    ds.mag = np.full(T * n_obs, np.nan)
    ds.catalog = np.full(T * n_obs, " ", dtype="U1")
    return ds


def _sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _summary(res):
    """Status histogram, IOD failures by error, converged fraction and the
    fallbacks to the IOD orbit of an unseeded fit."""
    import collections

    import numpy as np

    for tid, r in res.items():
        if r.ok:
            assert r.equinoctial.shape == (6,) and np.isfinite(r.equinoctial).all(), tid
            if not r.fell_back_to_iod:
                c = r.covariance
                assert c.shape == (6, 6) and np.isfinite(c).all() and (c == c.T).all(), tid
                assert (np.diag(c) > 0).all() and np.isfinite(r.normalised_rms), tid
        else:
            assert r.error.startswith(("IOD failed: ", "IOD seed not finite")), (tid, r.error)
    status = collections.Counter(r.status for r in res.values())
    iod_fail = collections.Counter(
        r.error[len("IOD failed: "):].split("(")[0] for r in res.values() if not r.ok and r.error.startswith("IOD failed")
    )
    converged = sum(r.ok and not r.fell_back_to_iod and r.status == 1 for r in res.values())
    fell = sum(r.fell_back_to_iod for r in res.values())
    return dict(status=dict(sorted(status.items())), iod_failures=dict(iod_fail),
                converged=converged, total=len(res), fallbacks=fell)


def _same_fit(a, b, covariance=False):
    """The same outcome, IOD RMS and elements, bitwise (and, with
    ``covariance``, the same covariance)."""
    import numpy as np

    if (a.ok, a.error, a.status, a.fell_back_to_iod) != (b.ok, b.error, b.status, b.fell_back_to_iod):
        return False
    if (a.iod is None) != (b.iod is None):
        return False
    if a.iod is not None and (a.iod.ok, a.iod.rms) != (b.iod.ok, b.iod.rms):
        return False
    if covariance and (a.covariance is None) != (b.covariance is None):
        return False
    if covariance and a.covariance is not None and not np.array_equal(a.covariance, b.covariance):
        return False
    return a.equinoctial is None and b.equinoctial is None or np.array_equal(a.equinoctial, b.equinoctial)


def count_syncs(fn):
    """Host syncs of ``fn()`` on the card: torch's sync debug mode warns at
    every synchronising call; count those warnings."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _profiled(fn, dev):
    """(wall s, device busy s, kernels and copies, top events) of one ``fn()``
    under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity only: the host operator events of ~10^5 launches would
    # cost the trace's post-processing tens of seconds
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        _sync(dev)
        wall = time.perf_counter() - t
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return out, wall, busy, sum(e.count for e in events), top


#: the IOD stage's parts, timed by :func:`iod_breakdown`: (module, name)
IOD_PARTS = (
    ("outfit_tpu_torch.iod.api", "_enum_device"),
    ("outfit_tpu_torch.iod.api", "draw_noise"),
    ("outfit_tpu_torch.iod.gauss", "aberth_deg8"),
    ("outfit_tpu_torch.iod.gauss", "_fg_correction"),
    ("outfit_tpu_torch.iod.api", "candidates_to_elements"),
    ("outfit_tpu_torch.iod.api", "rms_orbit_error"),
)


def iod_breakdown(fn, dev):
    """Wall seconds of the IOD's parts in one ``fn()``: each part is wrapped
    by a timer that synchronises the card before and after it."""
    import importlib

    spent = {}
    saved = []
    for mod_name, name in IOD_PARTS:
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, name)
        saved.append((mod, name, orig))

        def timed(*a, _orig=orig, _name=name, **k):
            _sync(dev)
            t = time.perf_counter()
            out = _orig(*a, **k)
            _sync(dev)
            spent[_name] = spent.get(_name, 0.0) + time.perf_counter() - t
            return out

        setattr(mod, name, timed)
    try:
        t = time.perf_counter()
        fn()
        _sync(dev)
        total = time.perf_counter() - t
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    parts = ", ".join(f"{k} {v!r} s" for k, v in spent.items())
    _log(f"  IOD parts (synchronised timers, wall {total!r} s): {parts}; rest {total - sum(spent.values())!r} s")


def profile_stages(dev, eph, ds, params, cfg, seed):
    """One warm unseeded fit as its two stages on a shared observer cache,
    each profiled and its host syncs counted: the IOD
    (``fit_full_iod``) and the correction from its orbits."""
    from outfit_tpu_torch import fit_full_iod, fit_lsq
    from outfit_tpu_torch.observer.cache import ObserverCache

    cache = ObserverCache.build(ds, eph, device=dev)
    _sync(dev)
    stages = {
        "iod": lambda: fit_full_iod(ds, eph, params, seed, cache=cache, device=dev),
    }
    iod, wall, busy, n, top = _profiled(stages["iod"], dev)
    stages["lsq"] = lambda: fit_lsq(ds, eph, params, cfg, seed, initial_orbits=iod, cache=cache, device=dev)
    report = {"iod": (wall, busy, n, top)}
    report["lsq"] = _profiled(stages["lsq"], dev)[1:]
    iod_breakdown(stages["iod"], dev)
    for name, (wall, busy, n, top) in report.items():
        syncs = count_syncs(stages[name])
        _log(f"  profiled warm {name}: wall {wall!r} s, device busy {busy!r} s ({100.0 * busy / wall:.1f} %), "
             f"{n} kernels and copies, {syncs} host syncs")
        for e in top:
            _log(f"    {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:6d}  {e.key[:90]}")


def cross_check_unseeded(dev, eph, ds, params, cfg, seed):
    """Card against CPU on the first trajectories: the same IOD ok/error/
    kind/corrected and LSQ statuses, IOD elements and RMS at rtol 1e-8, LSQ
    elements at rtol 1e-6 / atol 1e-9.  A trajectory whose IOD winner
    changed between two near-tied candidates (RMS within 1e-6) is printed
    and left out of the element checks; any other difference fails."""
    import numpy as np

    from outfit_tpu_torch import fit_lsq

    rg = fit_lsq(head(ds, N_CHECK), eph, params, cfg, seed, device=dev)
    rc = fit_lsq(head(ds, N_CHECK), eph, params, cfg, seed, device="cpu")
    worst_iod = worst_lsq = 0.0
    ties = []
    for tid in rc:
        a, b = rc[tid], rg[tid]
        ia, ib = a.iod, b.iod
        if (ia.ok, ia.error, ia.kind, ia.corrected) != (ib.ok, ib.error, ib.kind, ib.corrected):
            raise AssertionError(f"{tid}: IOD differs card/CPU: {ia} vs {ib}")
        if ia.ok:
            rel = np.abs(ib.equinoctial - ia.equinoctial) / (np.abs(ia.equinoctial) + 1e-12)
            d = max(float(rel.max()), abs(ib.rms - ia.rms) / ia.rms)
            if d > IOD_RTOL:
                if d > 1e-6 and abs(ib.rms - ia.rms) <= 1e-6 * ia.rms:
                    ties.append(tid)
                    _log(f"  {tid}: IOD winner differs card/CPU between near-tied candidates "
                         f"(RMS {ib.rms!r} vs {ia.rms!r}); left out of the element checks")
                    continue
                raise AssertionError(f"{tid}: IOD card/CPU deviation {d!r} > {IOD_RTOL}")
            worst_iod = max(worst_iod, d)
        if (a.ok, a.status, a.fell_back_to_iod) != (b.ok, b.status, b.fell_back_to_iod):
            raise AssertionError(f"{tid}: LSQ differs card/CPU: {a.status} vs {b.status}")
        if a.ok:
            np.testing.assert_allclose(b.equinoctial, a.equinoctial, rtol=1e-6, atol=1e-9, err_msg=tid)
            worst_lsq = max(worst_lsq, float(np.max(np.abs(b.equinoctial - a.equinoctial))))
    _log(f"  card vs CPU, {len(rc)} trajectories: same IOD and LSQ outcomes; IOD max rel dev {worst_iod!r}, "
         f"LSQ max |d elements| {worst_lsq!r}; near-tie winner changes {len(ties)}")


def phase_unseeded(dev, eph, ds, params, cfg, seed, tag, profile=True):
    """The unseeded fit: cold and warm wall, outcome summary, kernel
    launches, a profiled warm fit split by stage and card against CPU (or,
    ``profile=False``, neither).  Returns (launches, warm wall, summary)."""
    from outfit_tpu_torch import fit_lsq
    from outfit_tpu_torch.ephem import chebyshev_cuda

    _log(f"{tag}: {len(ds.traj_ids)} trajectories, {len(ds.mjd_tt)} observations; {params!r}; {cfg!r}")
    chebyshev_cuda.reset_launch_counts()
    t = time.perf_counter()
    res = fit_lsq(ds, eph, params, cfg, seed, device=dev)
    _sync(dev)
    cold = time.perf_counter() - t
    launches = dict(chebyshev_cuda.launches)
    t = time.perf_counter()
    res_w = fit_lsq(ds, eph, params, cfg, seed, device=dev)
    _sync(dev)
    warm = time.perf_counter() - t
    _log(f"{tag} wall: cold {cold!r} s, warm {warm!r} s; kernel launches in the cold run {launches}")
    _launched(tag, launches)
    assert list(res) == ds.traj_ids, "one result per trajectory, in dataset order"
    for tid in ds.traj_ids:
        if not _same_fit(res[tid], res_w[tid]):
            raise AssertionError(f"{tid}: cold and warm runs differ")
    summ = _summary(res)
    _log(f"{tag} outcome: {summ}; converged fraction {summ['converged'] / summ['total']!r}")
    if profile:
        profile_stages(dev, eph, ds, params, cfg, seed)
        cross_check_unseeded(dev, eph, ds, params, cfg, seed)
    return launches, warm, summ


def orbit_deviation(a, b):
    """How far two fits of one arc are from the same optimum, in the terms
    of the JAX suite's same-orbit bar (tests/test_lsq.py:206-227): the nRMS
    difference relative to 1 + nRMS (0 when both are below 1e-4), the
    largest (a, h, k, p, q) difference relative to 0.01 + |element| (the
    bar's atol / rtol), and the mean-longitude difference in radians once
    advanced to a common epoch at the fitted mean motion."""
    import numpy as np

    from outfit_tpu_torch.constants import GAUSS_GRAV

    na, nb = a.normalised_rms, b.normalised_rms
    d_nrms = 0.0 if na < 1e-4 and nb < 1e-4 else abs(nb - na) / (1.0 + abs(na))
    ea, eb = np.asarray(a.equinoctial), np.asarray(b.equinoctial)
    d_el = float(np.max(np.abs(eb[:5] - ea[:5]) / (1e-2 + np.abs(ea[:5]))))
    lam = eb[5] + GAUSS_GRAV / float(ea[0]) ** 1.5 * (a.epoch - b.epoch)
    return d_nrms, d_el, float(abs((lam - ea[5] + np.pi) % (2 * np.pi) - np.pi))


def seed_grade_stats(ref, got, tag):
    """Mixed-precision results ``got`` against ``ref`` on the same rows, at
    the JAX suite's seed grade (tests/test_iod.py::TestMixedPrecision):
    raises unless the IOD success sets are identical.  Returns the IOD RMS
    ratios and element deviations of the rows with an IOD orbit; the rows
    whose winner changed (IOD elements apart by more than 1e-6: near-tied
    candidates or Monte-Carlo lanes that float32 rounds differently on the
    two sides); the rows with the same winner and another LSQ outcome; and
    ``{tid: orbit_deviation}`` of the rows with the same winner and the
    same usable outcome."""
    import numpy as np

    assert list(ref) == list(got), f"{tag}: different rows"
    ratio, rel, flips, changed, devs = [], [], [], [], {}
    for tid, a in ref.items():
        b = got[tid]
        ia, ib = a.iod, b.iod
        if (ia is None) != (ib is None) or (ia is not None and ia.ok != ib.ok):
            raise AssertionError(f"{tag} {tid}: IOD success differs")
        if ia is None or not ia.ok:
            continue
        ratio.append(ib.rms / ia.rms)
        d = float(np.max(np.abs(ib.equinoctial - ia.equinoctial) / (1.0 + np.abs(ia.equinoctial))))
        rel.append(d)
        if d > 1e-6:
            flips.append(tid)
        elif (a.ok, a.status, a.fell_back_to_iod) != (b.ok, b.status, b.fell_back_to_iod):
            changed.append(tid)
        elif a.ok:
            devs[tid] = orbit_deviation(a, b)
    return np.array(ratio), np.array(rel), flips, changed, devs


def seed_grade_check(ref, got, tag):
    """:func:`seed_grade_stats` held to the bars: IOD RMS ratio median <
    1.001, 90th percentile < 1.2, max < 2; IOD elements with median
    relative difference < 1e-8; at most ``MAX_WINNER_CHANGES`` winner
    changes and ``MAX_OUTCOME_CHANGES`` same-winner rows with another LSQ
    outcome; every other same-winner row in the same nRMS basin
    (tests/test_lsq.py:206-209, fallbacks and nRMS >= 2 included) but at
    most ``MAX_MOVED``, and each row in the basin with its elements inside
    ``ELEMENT_SPREAD`` and ``LAMBDA_SPREAD``.  The JAX suite's element bar
    (1e-8, tests/test_lsq.py:219-227) is for zero-noise arcs; on these 12
    noisy observations over 40 days the chi-squared valley is flat, and
    four Newton steps from float32 starts that round differently on the
    two sides stop up to 3.5e-3 apart in it at the same nRMS."""
    import numpy as np

    ratio, rel, flips, changed, devs = seed_grade_stats(ref, got, tag)
    moved = [t for t, (dn, _, _) in devs.items() if dn >= 1e-6]
    spread = [t for t, (dn, de, dl) in devs.items() if dn < 1e-6 and (de > ELEMENT_SPREAD or dl > LAMBDA_SPREAD)]
    basin = [d for d in devs.values() if d[0] < 1e-6]
    ok = (np.median(ratio) < 1.001 and np.percentile(ratio, 90) < 1.2 and ratio.max() < 2.0
          and np.median(rel) < 1e-8 and len(flips) <= MAX_WINNER_CHANGES and len(changed) <= MAX_OUTCOME_CHANGES
          and len(moved) <= MAX_MOVED and not spread)
    _log(f"  {tag}: IOD RMS ratio median {float(np.median(ratio))!r}, p90 {float(np.percentile(ratio, 90))!r}, "
         f"max {float(ratio.max())!r}; IOD elements median rel {float(np.median(rel))!r}; "
         f"winner changes {len(flips)} of {len(ref)} (limit {MAX_WINNER_CHANGES}); same winner: other LSQ outcome "
         f"{len(changed)} (limit {MAX_OUTCOME_CHANGES}), left the nRMS basin {len(moved)} of {len(devs)} "
         f"(limit {MAX_MOVED}), in the basin max element spread {max((d[1] for d in basin), default=0.0)!r}, "
         f"mean longitude {max((d[2] for d in basin), default=0.0)!r} rad, beyond the limits {len(spread)}")
    if not ok:
        raise AssertionError(f"{tag}: outside the seed-grade bars")


def _launched(tag, launches):
    if not (launches["body"] > 0 and launches["frame"] > 0):
        raise AssertionError(f"{tag}: the path did not launch the kernel at both sites: {launches}")


def phase_mixed(dev, eph, ds, params, cfg, seed, f64_warm, f64_summ):
    """Phase 8: the headline profile in mixed precision."""
    import torch

    from outfit_tpu_torch import fit_lsq

    tag = "mixed synthetic 8192 x 12 IOD+LSQ"
    launches, warm, summ = phase_unseeded(dev, eph, ds, params, cfg, seed, tag, profile=False)
    _log(f"{tag}: converged fraction mixed {summ['converged'] / summ['total']!r} vs float64 (phase 6) "
         f"{f64_summ['converged'] / f64_summ['total']!r}; warm wall mixed {warm!r} s vs float64 {f64_warm!r} s")
    profile_stages(dev, eph, ds, params, cfg, seed)
    rg = fit_lsq(head(ds, N_CHECK), eph, params, cfg, seed, device=dev)
    rc = fit_lsq(head(ds, N_CHECK), eph, params, cfg, seed, device="cpu")
    seed_grade_check(rc, rg, f"card vs CPU, {N_CHECK} trajectories")
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        out = {}
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            out[flag] = fit_lsq(ds, eph, params, cfg, seed, device=dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for tid in out[False]:
        if not _same_fit(out[False][tid], out[True][tid]):
            raise AssertionError(f"{tid}: mixed results depend on allow_tf32")
    _log(f"  allow_tf32 False / True: identical results on all {len(ds.traj_ids)} trajectories")
    return launches


def _slim_matches(r, ref, tid):
    """The slim contract of one row against its sequential fit."""
    import numpy as np

    if (r.ok, r.status, r.fell_back_to_iod, r.error) != (ref.ok, ref.status, ref.fell_back_to_iod, ref.error):
        raise AssertionError(f"{tid}: slim stream outcome differs")
    if ref.equinoctial is not None and not np.array_equal(r.equinoctial, ref.equinoctial):
        raise AssertionError(f"{tid}: slim stream elements differ")
    if ref.covariance is not None:
        if r.normalised_rms != ref.normalised_rms:
            raise AssertionError(f"{tid}: slim stream RMS differs")
        if not np.array_equal(r.covariance, ref.covariance.astype(np.float32).astype(np.float64)):
            raise AssertionError(f"{tid}: slim covariance is not the float32 rounding")


def _rows(out):
    """``{(dataset position, traj id): LsqResult}`` of a stream's output
    (per-row dicts or tables)."""
    rows = {}
    for k, (_, res) in enumerate(out):
        if isinstance(res, dict):
            rows.update(((k, tid), r) for tid, r in res.items())
        else:
            rows.update(((k, tid), res.result(tid)) for tid in res.traj_ids)
    return rows


def _timed_stream(tag, run, datasets, launches, dev):
    """One pass of a stream with the kernel's counts reset just before it:
    (output, wall, launches of the pass), the launches added to
    ``launches``."""
    from outfit_tpu_torch.ephem import chebyshev_cuda

    chebyshev_cuda.reset_launch_counts()
    t = time.perf_counter()
    out = list(run())
    _sync(dev)
    wall = time.perf_counter() - t
    got = dict(chebyshev_cuda.launches)
    _launched(tag, got)
    for site in launches:
        launches[site] += got[site]
    assert [id(d) for d, _ in out] == [id(d) for d in datasets], f"{tag}: input order"
    return out, wall, got


def phase_stream(dev, eph, dataset_seeds, params, cfg, seed):
    """Phase 9: fit_lsq_stream, default (cold and warm) and
    slim/table/minimal, against sequential fits of the same datasets."""
    import numpy as np

    from outfit_tpu_torch import fit_lsq, fit_lsq_stream

    datasets = [synthetic_dataset(N_SYNTH, N_SYNTH_OBS, eph, seed=s) for s in dataset_seeds]
    n = sum(len(d.traj_ids) for d in datasets)
    launches = {"body": 0, "frame": 0}

    def stream(**kw):
        return lambda: fit_lsq_stream(datasets, eph, params, cfg, seed, device=dev, **kw)

    cold, cold_wall, got = _timed_stream("stream default, cold", stream(), datasets, launches, dev)
    warm, warm_wall, _ = _timed_stream("stream default, warm", stream(), datasets, launches, dev)
    t = time.perf_counter()
    seq = [fit_lsq(d, eph, params, cfg, seed, device=dev) for d in datasets]
    _sync(dev)
    seq_wall = time.perf_counter() - t
    ref = _rows(zip(datasets, seq))
    for rows in (_rows(cold), _rows(warm)):
        for key, r in ref.items():
            got_r = rows[key]
            if not _same_fit(got_r, r) or (r.covariance is not None and not np.array_equal(got_r.covariance, r.covariance)):
                raise AssertionError(f"{key}: stream differs from the sequential fit")
    summ = _summary(ref)
    _log(f"stream default: {n} fits over {len(datasets)} datasets, cold {cold_wall!r} s, warm {warm_wall!r} s "
         f"({n / warm_wall!r} fits/s) vs sequential {seq_wall!r} s ({n / seq_wall!r} fits/s); "
         f"kernel launches in the cold pass {got}")
    _log(f"stream outcome: {summ}; converged fraction {summ['converged'] / summ['total']!r}")
    out, wall, got = _timed_stream("stream slim+table+minimal", stream(slim_fetch=True, as_table=True,
                                                                       minimal_fetch=True), datasets, launches, dev)
    for (_, res), r in zip(out, seq):
        assert res.traj_ids == list(r)
        assert np.isnan(res.iod_equinoctial[res.converged]).all(), "minimal: converged rows' IOD columns are NaN"
        for tid, ref_r in r.items():
            _slim_matches(res.result(tid), ref_r, tid)
    _log(f"stream slim+table+minimal: {n} fits in {wall!r} s ({n / wall!r} fits/s); kernel launches {got}")
    return launches


def phase_escalating(dev, eph, seeds, stages, seed):
    """Phase 10: fit_lsq_stream_escalating over real-cadence datasets."""
    import numpy as np

    from outfit_tpu_torch import ObsDataset, fit_lsq, fit_lsq_escalating, fit_lsq_stream, fit_lsq_stream_escalating

    datasets = [real_cadence_dataset(N_TRAJ, seed=s)[0] for s in seeds]
    n = sum(len(d.traj_ids) for d in datasets)
    kw = dict(slim_fetch=True, as_table=True, minimal_fetch=True)
    (lean, lean_cfg), (rich, rich_cfg) = stages
    launches = {"body": 0, "frame": 0}
    runs = {}
    for name, run in (
        ("lean tier alone", lambda: fit_lsq_stream(datasets, eph, lean, lean_cfg, seed, depth=3, device=dev, **kw)),
        ("escalating, cold", lambda: fit_lsq_stream_escalating(datasets, eph, stages, seed, flush_every=3, depth=3,
                                                               device=dev, **kw)),
        ("escalating, warm", lambda: fit_lsq_stream_escalating(datasets, eph, stages, seed, flush_every=3, depth=3,
                                                               device=dev, **kw)),
    ):
        out, wall, got = _timed_stream(name, run, datasets, launches, dev)
        runs[name] = _rows(out)
        summ = _summary(runs[name])
        _log(f"real-cadence escalating, {name}: {n} fits in {wall!r} s ({n / wall!r} fits/s); {summ}; "
             f"converged fraction {summ['converged'] / n!r}; kernel launches {got}")
    esc, lean_rows = runs["escalating, warm"], runs["lean tier alone"]
    for key, r in runs["escalating, cold"].items():
        if not _same_fit(r, esc[key]):
            raise AssertionError(f"{key}: cold and warm escalating passes differ")
    # the default predicate escalates exactly the rows the lean tier did not
    # converge; the others keep their lean result
    retry = [key for key, a in lean_rows.items() if not a.ok or a.fell_back_to_iod]
    if not retry:
        raise AssertionError("the lean tier converged every row: nothing was escalated")
    for key, a in lean_rows.items():
        if key not in retry and not _same_fit(a, esc[key]):
            raise AssertionError(f"{key}: a lean-converged row changed in the escalating stream")

    def rich_by_hand(parts, rename=None):
        """The rich stage on the given rows of the given datasets (several:
        concatenated under ``rename``), called by hand."""
        subs = [d.subset(np.concatenate([dict(d.trajectory_groups())[t] for t in tids])) for d, tids in parts]
        batch = subs[0] if rename is None else ObsDataset.concat(subs, rename=rename)
        return fit_lsq(batch, eph, rich, rich_cfg, seed, device=dev)

    # every escalated row carries the rich stage's result, fitted (as the
    # flush does) in one batch over the three datasets' failures under
    # "<dataset>|<id>"
    parts = [(k, datasets[k], [t for j, t in retry if j == k]) for k in range(len(datasets))]
    parts = [p for p in parts if p[2]]
    refit = rich_by_hand([(d, tids) for _, d, tids in parts], rename=lambda i, t: f"{parts[i][0]}|{t}")
    for k, tid in retry:
        if not _same_fit(esc[(k, tid)], refit[f"{k}|{tid}"], covariance=True):
            raise AssertionError(f"{(k, tid)}: the escalated row does not carry the rich stage's result")
    _log(f"  escalating stream: {len(retry)} rows escalated, each equal to the rich stage by hand on the same batch")

    # fit_lsq_escalating on the first dataset against its stages by hand
    ds = datasets[0]
    tiered = fit_lsq_escalating(ds, eph, stages, seed, device=dev)
    by_hand = fit_lsq(ds, eph, lean, lean_cfg, seed, device=dev)
    retry0 = [tid for tid, r in by_hand.items() if not r.ok or r.fell_back_to_iod]
    if retry0 != [t for k, t in retry if k == 0]:
        raise AssertionError("the lean tier escalates different rows in the stream and in fit_lsq_escalating")
    if retry0:
        by_hand.update(rich_by_hand([(ds, retry0)]))
    assert list(tiered) == list(by_hand), "fit_lsq_escalating: rows or their order differ"
    for tid, r in by_hand.items():
        if not _same_fit(tiered[tid], r, covariance=True):
            raise AssertionError(f"{tid}: fit_lsq_escalating differs from its stages called by hand")
    # the same rows refitted in a batch of their own and in the stream's
    # three-dataset batch: the lanes are batch-isolated
    for t in retry0:
        if not _same_fit(tiered[t], esc[(0, t)], covariance=True):
            raise AssertionError(f"{t}: the escalated row differs between fit_lsq_escalating and the stream")
    _log(f"  fit_lsq_escalating on dataset 0 ({len(retry0)} escalated) equals its stages by hand row by row, "
         f"and its escalated rows equal the stream's bitwise")
    return launches


def main():
    sys.path.insert(0, HERE)
    dev = phase_device()
    import torch

    phase_build()
    from outfit_tpu_torch import JPLEphem

    eph = JPLEphem.analytic(*SPAN)
    ds, picks = real_cadence_dataset(N_TRAJ)
    times = phase_kernel_check(dev, eph, ds)
    launches, _, _, _ = phase_slice(dev, eph, ds, picks)
    phase_cross_check(dev, eph, ds, picks)

    from outfit_tpu_torch import DifferentialCorrectionConfig, IODParams

    synth = synthetic_dataset(N_SYNTH, N_SYNTH_OBS, eph)
    lean = IODParams(n_noise_realizations=3, newton_max_it=20, max_triplets=2)
    cfg = DifferentialCorrectionConfig(divergence_grace_iterations=2, max_newton_iterations=4)
    rich = IODParams(n_noise_realizations=0, newton_max_it=20, max_triplets=16, max_obs_for_triplets=48)
    f64 = {}
    for tag, data, params, config in (
        ("synthetic 8192 x 12 IOD+LSQ", synth, lean, cfg),
        ("real-cadence 4096 IOD+LSQ", ds, rich, DifferentialCorrectionConfig()),
    ):
        t = time.perf_counter()
        got, *f64[tag] = phase_unseeded(dev, eph, data, params, config, 7, tag)
        _log(f"{tag} phase: {time.perf_counter() - t!r} s")
        for site in launches:
            launches[site] += got[site]

    # the JAX bench's production profiles (bench.py:509-556), mixed precision
    headline = IODParams(n_noise_realizations=3, precision="mixed", newton_max_it=20, max_triplets=2)
    headline_cfg = DifferentialCorrectionConfig(divergence_grace_iterations=2, precision="mixed",
                                                max_newton_iterations=4, prewarm_max_iterations=16)
    rc_rich = IODParams(n_noise_realizations=0, precision="mixed", newton_max_it=20, max_triplets=16,
                        max_obs_for_triplets=48)
    rc_lean = IODParams(n_noise_realizations=0, precision="mixed", newton_max_it=10, max_triplets=4,
                        max_obs_for_triplets=32)
    rc_lean_cfg = DifferentialCorrectionConfig(divergence_grace_iterations=2, precision="mixed",
                                               max_newton_iterations=4, prewarm_max_iterations=16,
                                               max_outlier_rejection_passes=3)
    for tag, run in (
        ("mixed synthetic 8192 x 12 IOD+LSQ", lambda: phase_mixed(
            dev, eph, synth, headline, headline_cfg, 7, *f64["synthetic 8192 x 12 IOD+LSQ"])),
        ("stream synthetic 3 x 8192 x 12", lambda: phase_stream(dev, eph, (400, 401, 402), headline, headline_cfg, 7)),
        ("escalating real-cadence 3 x 4096", lambda: phase_escalating(
            dev, eph, (101, 102, 103), [(rc_lean, rc_lean_cfg), (rc_rich, headline_cfg)], 7)),
    ):
        t = time.perf_counter()
        got = run()
        _log(f"{tag} phase: {time.perf_counter() - t!r} s")
        for site in launches:
            launches[site] += got[site]

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SRC,
            "replaces": REPLACES,
            "launches": launches[site],
            "max_abs_err": t["err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
        }
        for name, site, t in (
            ("chebyshev_body", "body", times["chebyshev_body"]),
            ("chebyshev_frame", "frame", times["chebyshev_frame"]),
        )
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
