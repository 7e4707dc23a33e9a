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
5. card against CPU on the first 64 trajectories of the same dataset.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
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
SPAN = (53500.0, 61500.0)
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
