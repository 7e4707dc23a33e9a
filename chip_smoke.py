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
   nvcc and prints the seconds it took and the registers of the
   instantiations the fitting path uses;
3. kernel against its plain PyTorch version on the card, at the shapes of
   the fitting path below: the observer cache's query epochs of phases 4
   and 6 (309,892 and 98,304 epochs, padded to 524,288 and 131,072), in
   path order and shuffled, and 37 of them, through the EMB and Moon tables
   and the dataset's 10-channel frame table; then through every planet table
   the N-body path queries (Mercury to Pluto: 8, 10, 12 and 14
   coefficients) at that path's shapes, 4,096 and 98,304 stage epochs in
   lane order; max deviation against the JAX
   package's bar for its Pallas kernel (times the table's largest distance
   where that is over 1 AU), the kernel's device time (20
   launches queued behind a sleep kernel, between CUDA events), its bound
   (bytes over the H100's 3.35 TB/s or float64 operations over 34 TFLOP/s,
   the larger; the bytes of the epochs, the outputs and the table rows the
   call reads) and their ratio, and at phase 4's shape one call of the
   wrapper and of the plain version (CUDA events around the call);
3c. the IOD's f-g correction kernel (``outfit_tpu_torch/csrc/
   fg_correction.cuh``) against its plain loop on the card at the stream's
   shapes: the calls of one mixed IOD of phase 8's profile (the float32
   candidate pass over 65,536 lanes x 3 candidates, the float64 polish of
   8,192 winners) and one float64 IOD on phase 6's dataset, each through
   the kernel and the plain loop: the site ``iod_fg``'s trips, live and
   lanes identical, and every output bitwise (equal, or NaN where the
   plain loop's is NaN); ptxas's registers and spills, the
   kernel's device time (as phase 3's), its bound (bytes over 3.35 TB/s or
   the live trips' operations, counted with one Newton step a side, over
   67 TFLOP/s float32 or 34 TFLOP/s float64, the larger) and their ratio,
   and the plain loop's wall;
3d. the correction's two-body Newton step kernel (``outfit_tpu_torch/csrc/
   lsq_step.cuh``) against ``_single_iteration_plain`` on the card, every
   step of a mixed fit of phase 8's profile on phase 6's 8,192 x 12
   dataset (its three working types: the float32 pre-warm, float64 with
   float32 Jacobians, the float64 final linearisation) and of phase 4's
   seeded float64 fit (4,096 x 129): every valid observation's residuals,
   masked partials, active flags and Kepler states bitwise, the sums over
   observations and what follows from them within the bounds
   :func:`step_against_plain` states; ptxas's registers and spills, and
   for the last step of each type and shape the kernel's device time (as
   phase 3's), its bound (every byte read or written once over 3.35 TB/s)
   and their ratio, and the plain step's wall;
4. the seeded least-squares path at real size: the real-cadence workload
   (the fixtures 2015AB, 8467 and 33803 tiled round-robin to 4096
   trajectories, re-noised with ``default_rng(0)`` at the catalog sigma),
   each copy seeded with its base fixture's orbit from
   tests/data/iod_seeds_analytic.json, through
   ``outfit_tpu_torch.fit_lsq(..., initial_orbits=seeds, device="cuda")``
   once cold and once warm; the cold run must launch the kernel twice at
   the body site (the EMB and Moon tables) and once at the frame site;
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

11. N-body propagation at the JAX bench's size (``bench.py:684-739``): 4,096
   lanes from ``default_rng(3)`` (a = U[1.2, 3.5], e = U[0, 0.35], epoch
   57000, t1 = 57000 + U[25, 30] d), ``NBodyConfig.with_planets()`` with the
   42-state STM, through ``outfit_tpu_torch.propagate_nbody`` on the card,
   cold and warm, with frozen and then moving perturbers: every lane status
   0; Sun-only N-body equal to ``propagate_twobody`` (1e-11 AU, 1e-12
   AU/day); frozen and moving within 5e-10 AU; card against CPU on 64 lanes
   at 1e-10 AU; exactly 9 kernel launches per frozen call and 9 x 13 x trips
   with moving perturbers; accepted steps, trips, launches, host syncs,
   device busy share, the kernel's share, warm wall and steps/s;
12. ephemeris generation end to end: phase 6's float64 results (8,192
   trajectories; failed fits ride along as row errors) through
   ``outfit_tpu_torch.compute_ephemerides_batch`` with two observers (the
   geocenter and station 809) x 32 daily epochs (57004 to 57035, inside the
   fits' window), 64 pairs and 524,288
   entries, ``Combined`` output, at first- and second-order aberration, then
   on phase 9's ``LsqTable``: ok count = live rows x 64, angles in range,
   the orders within 1e-6 rad on the sky (a right-ascension difference
   counts times cos(dec)) on the orbits the correction converged onto their
   observations (normalised RMS <= 2), 8 rows equal to ``compute_ephemeris`` per
   orbit at 1e-13, card against CPU on 64 rows at 1e-12 rad, 2 kernel
   launches per call, the N-body propagator on 512 rows within 1e-5 rad of
   two-body on those orbits, entries/s cold and warm;
13. the correction with the N-body propagator: ``fit_lsq(synth, eph, lean,
   DifferentialCorrectionConfig(propagator=PropagatorKind.n_body(
   NBodyConfig.with_planets()), divergence_grace_iterations=2,
   max_newton_iterations=4), initial_orbits=<phase 6's converged orbits>,
   device="cuda")`` on the synthetic 8192 x 12 (about 92,000 lanes of 42
   states; the rows that fell back to their IOD orbit in phase 6 are not
   seeded: those orbits reach e = 0.99, the integrator needs hundreds of
   steps through their perihelia, and every loop trip advances all lanes):
   converged fraction within 0.02 of phase 6's; elements against the
   two-body fit in its 1-sigma uncertainties (median <= 0.5, 99th percentile
   <= 5: the planets' pull over 40 days is of the size of the astrometric
   noise, so it moves a 12-observation fit inside its flat chi-squared
   valley), and the Sun-only N-body correction within 1e-4 relative of the
   two-body correction from the same orbits; card against CPU on 64 rows,
   2 + 9 per propagate body launches and 1 frame launch; trips per Newton
   step, launches, syncs, wall.  Then one fit of the first 2,048
   trajectories from every ok orbit of phase 6, the IOD fallbacks among
   them (what an unseeded N-body fit hands its correction; at all 8,192 it
   takes over 40 s a fit): the same launch formula, the integrator's step
   budget bounding the trips, the converged fraction within 0.02 of
   phase 6's on the same rows, and its trips per Newton step beside the
   converged seeds'.
14. from files to orbits: the analytic source refitted over DE440's span
   (MJD -112816 to 288976) at DE440's granules and coefficient counts
   (``DE440_LAYOUT``: 6, 7, 8, 10, 11, 13 and 14 per component, up to
   100,448 granules), written with the port's writers as a NAIF SPK kernel
   (the nine barycentres and a zero Sun relative to the barycentre, 301
   and 399 relative to the EMB) and as a legacy DE binary, parsed through
   ``JPLEphem("naif:DE440", path=...)`` and ``JPLEphem("horizon:DE440",
   path=...)`` (parse seconds, bytes on the card); the kernel against its
   plain version on every parsed table at 4,096, 98,304 and 524,288 epochs
   (phase 3's query sets and scaled bar; device time, bound over the rows
   the call reads, share and the plain version's ms); phase 4's own tables through a Horizon file
   (``au_km`` 2^27, a zero Sun): its seeded fit bitwise phase 4's on every
   row; the seeded fit from each DE440-layout file (NAIF against Horizon at
   rtol 1e-6 / atol 1e-9, converged count within 0.1 % of phase 4's, card
   against CPU on 64 rows); phase 4's dataset written as MPC 80-column
   records and as ADES XML, parsed by the native parser (which must have
   built), by the Python parser (the two datasets identical in indices,
   catalogs and observers, epochs within 1e-9 d and angles within 1e-12
   rad) and by ``from_ades``, each fitted from the NAIF file (records/s,
   converged counts); an NSIDE-64 debiasing table for the dataset's
   catalog codes (``default_rng(14)``, sub-arcsecond) written and loaded,
   the observations shifted by its bias and ``apply_debias``-ed, fitted in
   float64 and in mixed precision, each against the fit of the data
   debiased on the host in the same precision on the rows converged in
   both: float64 at rtol 1e-7 / atol 1e-9, mixed with the same active
   observations and within ``MIXED_DEBIAS_SIGMA`` of the 1-sigma
   uncertainties (rows off rtol 1e-7 counted), and the shifted data fitted
   without its bias moving the orbits by more than 1e-6.  Every fit from a DE file
   launches the kernel three times at the body site (EMB, Moon or Earth,
   Sun) and once at the frame site; fits/s beside phase 4's.
15. fits split over a device list (one card named several times; a worker
   thread per entry, each fitting a contiguous chunk of the trajectories
   after the observer cache is built once on the first): phase 4's seeded
   fit with ``device=["cuda:0"] * 2``, ``["cuda:0"] * 3`` (chunks of 1360,
   1376 and 1360 trajectories: a chunk starts a multiple of 16 rows into
   the batch, ``parallel.sharding.CHUNK_ROWS``), ``"auto"`` and None;
   phase 8's mixed fit and
   phase 9's slim/table/minimal stream split two ways; phase 10's
   ``fit_lsq_escalating`` on its first dataset split two ways; phase 6's fit
   through ``fit_lsq_dispatch`` / ``fit_lsq_finalize`` as a dict and as a
   table.  Each is bitwise its earlier single-device result on every field
   of every row (``total_newton_iterations`` included) and builds one
   observer cache per fit (2 body + 1 frame launches); then phase 4's warm
   wall and fits/s on one device and split two ways, in turns.

Phases 11 to 14 print the card's peak memory.  Phases 6 to 10 each run one cold and one warm pass (results must agree),
print the outcome histogram and require, in the pass the counts were reset
for, two body launches and one frame launch per observer cache build (one
per dataset fit, and one for the escalating flush's refit); phases 6 and 7
also count the host syncs
of a warm fit, profile a warm fit split into its IOD and correction
stages, and hold card against CPU on the first 64 trajectories.

The line before the last is ``{"kernels": [...]}``: per K1 site the launches
summed over phases 4 and 6 to 15, the largest deviation of phases 3 and 14
(AU at the body site: an ulp or two of the outer planets' 30 AU), and at
phase 4's shape the device time (``device_ms``), the bound (``bound_ms``,
``bound_by``), one call of the wrapper (``ms``) and of the plain version
(``plain_ms``), and ``library_ms`` null (no single PyTorch call computes
the function); then per working type of the f-g correction kernel its
launches summed over phases 4 to 15 (each phase's held to two per mixed
IOD chunk on the card, one of each type, and one per float64 chunk) and
phase 3c's times at the float32 candidate pass and the float64 IOD's
candidate pass; then per working type of the two-body step kernel its
launches summed over phases 4 to 15 (each phase's held to one per
two-body Newton step on the card, of its type, with
``trace.lsq_step.two_body`` counting every two-body step, card and CPU)
and phase 3d's times at the type's largest shape; the last line is ``{"ok": true, "device": {...}}``.
"""

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types

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
#: phase 11: the JAX bench's N-body lanes, and the orbit of the JAX suite's
#: N-body tests (Keplerian: epoch, a, e, i, node, argument, mean anomaly)
N_NBODY = 4096
JAX_TEST_ORBIT = (57000.0, 2.3, 0.15, 0.12, 1.1, 0.7, 0.3)
#: phase 13: how far the fit with the planets may lie from the two-body fit,
#: in that fit's 1-sigma uncertainties (median, 99th percentile), and the
#: most rows whose outcome may differ between the Sun-only N-body correction
#: and the two-body correction
NBODY_FIT_SIGMA, NBODY_FIT_CHANGED = (0.5, 5.0), 8
#: phase 13: the first trajectories that are also fitted from every ok orbit
#: of phase 6, the IOD-fallback orbits included
N_NBODY_FIT_ALL = 2048
KERNEL_SRC = "outfit_tpu_torch/csrc/chebyshev.cuh"
REPLACES = "outfit_tpu/ephem/pallas_kernel.py:123"
#: an H100 SXM's device-memory rate and float64 rate outside the tensor
#: cores, at its 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S, FP64_FLOP_PER_S = 3.35e12, 34e12


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
    # ptxas -v reports each instantiation (kernel<CH, DERIV, C>) as a
    # "Compiling entry" line, its spills, then its registers and shared memory
    kernel = spills = None
    for line in report.splitlines():
        m = re.search(r"chebyshev_eval_kernelILi(\d+)ELb([01])ELi(\d+)E", line)
        if "Compiling entry" in line and m:
            kernel = f"<{m[1]}, {'true' if m[2] == '1' else 'false'}, {m[3]}>"
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and kernel:
            if kernel.endswith((" 13>", " 14>")):
                _log(f"  kernel{kernel}: {line.split(':', 1)[1].strip()}; {spills}")
            kernel = None


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


def device_ms(launch, reps=20, batches=3):
    """Device milliseconds per call of ``launch()``: ``reps`` calls queued
    behind a sleep kernel, so that the host is ahead of the card, between
    two CUDA events; the median over ``batches``.  A batch whose sleep ended
    before the host had queued every call is taken again with a longer
    sleep, so no host time is inside the number."""
    import torch

    launch()
    torch.cuda.synchronize()
    cycles, times = 1 << 22, []
    while len(times) < batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            launch()
        ahead = not start.query()
        end.record()
        end.synchronize()
        if ahead:
            times.append(start.elapsed_time(end) / reps)
        else:
            cycles *= 2
    return statistics.median(times)


def padded_queries(mjd_tt):
    """The observer cache's query epochs: ``mjd_tt`` padded to a power of
    two (at least 8) with the first epoch repeated (observer/cache.py)."""
    import numpy as np

    nb = 8
    while nb < len(mjd_tt):
        nb *= 2
    return np.concatenate([mjd_tt, np.full(nb - len(mjd_tt), mjd_tt[0])])


def k1_flops(n_coeff, ch, deriv):
    """Floating-point operations of one K1 query: x and tau (5), the T_k
    recurrence (3 per k >= 2) and dT_k (5 more), the contraction (a multiply
    and an add per coefficient and channel, twice with the derivative) and
    the derivative's scale."""
    per_k = 3 + (5 if deriv else 0)
    return 5 + (n_coeff - 2) * per_k + n_coeff * ch * 2 * (2 if deriv else 1) + (ch if deriv else 0)


def touched_rows(mjd, t0, gran, n_gran):
    """The distinct table rows K1 reads for the epochs ``mjd``: their
    granule indices, clamped to the table (``ephem/chebyshev.py``)."""
    import numpy as np

    return len(np.unique(np.clip(np.floor((np.asarray(mjd) - t0) / gran), 0, n_gran - 1)))


def k1_bound_ms(n, coeffs_shape, deriv, rows=None):
    """(least milliseconds, "bytes" or "operations") of one K1 call on the
    card: each input byte read once (the epochs, and the table's rows the
    call reads: ``rows`` of them, every row when None), each output byte
    written once, over HBM_BYTES_PER_S, against the operations over
    FP64_FLOP_PER_S."""
    g, ch, c = coeffs_shape
    nbytes = 8 * (n + n * ch * (2 if deriv else 1) + (g if rows is None else rows) * ch * c)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = n * k1_flops(c, ch, deriv) / FP64_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_check(dev, eph, workloads):
    """Kernel against its plain version at the fitting path's shapes, and its
    device time against its bound.

    For each of ``workloads`` ({name: dataset}) the observer cache's query
    epochs (:func:`padded_queries`), in path order and shuffled (one fixed
    permutation), go through the three tables the cache evaluates: EMB and
    Moon at the body site, the dataset's frame table at the frame site; the
    first 37 epochs in path order too.  Prints per table the largest
    deviation, the device time (:func:`device_ms`), the bound
    (:func:`k1_bound_ms`) and their ratio; for the first workload in path
    order also one call of the wrapper and one of the plain version, each
    between CUDA events (the host's work inside).  Returns per site the
    ``kernels`` line's numbers: the largest deviation anywhere, and the
    times of the first workload in path order (the EMB table at the body
    site)."""
    import numpy as np
    import torch

    from outfit_tpu_torch.ephem.bodies import Body
    from outfit_tpu_torch.ephem.chebyshev import interpolate_body, interpolate_body_plain
    from outfit_tpu_torch.observer.cache import _frame_interp, _frame_interp_plain, _frame_table, frame_granules

    eph_d = eph.to(dev)
    out = {"body": {"err": 0.0}, "frame": {"err": 0.0}}
    for w, (name, ds) in enumerate(workloads.items()):
        q = padded_queries(ds.mjd_tt)
        n_gran, gran, t0 = frame_granules(ds.mjd_tt)
        frame = _frame_table(t0, gran, n_gran, dev)
        sites = [(b.name, "body", eph_d.tables[b].coeffs, (POS_ATOL, VEL_ATOL),
                  lambda m, t=eph_d.tables[b]: interpolate_body(t, m),
                  lambda m, t=eph_d.tables[b]: interpolate_body_plain(t, m),
                  touched_rows(q, eph_d.tables[b].t0, eph_d.tables[b].granule_days, eph_d.tables[b].coeffs.shape[0]))
                 for b in (Body.EMB, Body.MOON)]
        sites.append((f"G={n_gran}", "frame", frame, (FRAME_ATOL, FRAME_ATOL),
                      lambda m: _frame_interp(frame, m, t0, gran), lambda m: _frame_interp_plain(frame, m, t0, gran),
                      touched_rows(q, t0, gran, n_gran)))
        for order, qq in (("path", q), ("shuffled", np.random.default_rng(1).permutation(q))):
            mjd = torch.as_tensor(qq, dtype=torch.float64, device=dev)
            for label, site, coeffs, atol, kernel, plain, rows in sites:
                worst = 0.0
                for m in [mjd] + ([mjd[:37].contiguous()] if order == "path" else []):
                    for a, b, tol in zip(kernel(m), plain(m), atol):
                        d = (a - b).abs().max().item()
                        if not d <= tol:
                            raise AssertionError(f"K1 {site} {label} {name} {order} N={m.shape[0]}: "
                                                 f"deviates from its plain version by {d!r} > {tol}")
                        worst = max(worst, d)
                out[site]["err"] = max(out[site]["err"], worst)
                ms = device_ms(lambda: kernel(mjd))
                bound, by = k1_bound_ms(len(qq), tuple(coeffs.shape), site == "body", rows)
                line = (f"K1 {site} {label} {name} {order} N={len(qq)}: device {1e3 * ms!r} us, bound "
                        f"{1e3 * bound!r} us ({by}), share {bound / ms!r}; max|d| {worst!r}")
                if w == 0 and order == "path":
                    call_ms, plain_ms = _median_ms(lambda: kernel(mjd)), _median_ms(lambda: plain(mjd))
                    line += f"; one call {call_ms!r} ms, plain version {plain_ms!r} ms (median of 20)"
                    if label == "EMB" or site == "frame":
                        out[site].update(device_ms=ms, bound_ms=bound, bound_by=by, ms=call_ms, plain_ms=plain_ms)
                _log(line)
    return out


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
    _per_fit("seeded slice", launches, 1)
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
    return launches, cold, warm, res


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


def _profiled(fn, dev, n_top=6):
    """(wall s, device busy s, kernels and copies, the ``n_top`` events with
    the most device time, or all of them) of one ``fn()`` under
    torch.profiler."""
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
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:n_top]
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
    _per_fit(tag, launches, 1)
    assert list(res) == ds.traj_ids, "one result per trajectory, in dataset order"
    for tid in ds.traj_ids:
        if not _same_fit(res[tid], res_w[tid]):
            raise AssertionError(f"{tid}: cold and warm runs differ")
    summ = _summary(res)
    _log(f"{tag} outcome: {summ}; converged fraction {summ['converged'] / summ['total']!r}")
    if profile:
        profile_stages(dev, eph, ds, params, cfg, seed)
        cross_check_unseeded(dev, eph, ds, params, cfg, seed)
    return launches, warm, summ, res


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


def _per_fit(tag, launches, fits):
    """Each of ``fits`` observer cache builds launches the kernel twice at the
    body site (the EMB and Moon tables of one Earth-ephemeris evaluation)
    and once at the frame site."""
    if launches != {"body": 2 * fits, "frame": fits}:
        raise AssertionError(f"{tag}: {fits} cache build(s) should launch the kernel {2 * fits} times at the "
                             f"body site and {fits} at the frame site, got {launches}")


def phase_mixed(dev, eph, ds, params, cfg, seed, f64_warm, f64_summ):
    """Phase 8: the headline profile in mixed precision."""
    import torch

    from outfit_tpu_torch import fit_lsq

    tag = "mixed synthetic 8192 x 12 IOD+LSQ"
    launches, warm, summ, res = phase_unseeded(dev, eph, ds, params, cfg, seed, tag, profile=False)
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
    return launches, res


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


def _timed_stream(tag, run, datasets, launches, dev, fits):
    """One pass of a stream with the kernel's counts reset just before it,
    which must build ``fits`` observer caches: (output, wall, launches of
    the pass), the launches added to ``launches``."""
    from outfit_tpu_torch.ephem import chebyshev_cuda

    chebyshev_cuda.reset_launch_counts()
    t = time.perf_counter()
    out = list(run())
    _sync(dev)
    wall = time.perf_counter() - t
    got = dict(chebyshev_cuda.launches)
    _per_fit(tag, got, fits)
    for site in launches:
        launches[site] += got[site]
    assert [id(d) for d, _ in out] == [id(d) for d in datasets], f"{tag}: input order"
    return out, wall, got


def phase_stream(dev, eph, dataset_seeds, params, cfg, seed):
    """Phase 9: fit_lsq_stream, default (cold and warm) and
    slim/table/minimal, against sequential fits of the same datasets.
    Returns (launches, the datasets, their slim ``LsqTable``s)."""
    import numpy as np

    from outfit_tpu_torch import fit_lsq, fit_lsq_stream

    datasets = [synthetic_dataset(N_SYNTH, N_SYNTH_OBS, eph, seed=s) for s in dataset_seeds]
    n = sum(len(d.traj_ids) for d in datasets)
    launches = {"body": 0, "frame": 0}

    def stream(**kw):
        return lambda: fit_lsq_stream(datasets, eph, params, cfg, seed, device=dev, **kw)

    k = len(datasets)
    cold, cold_wall, got = _timed_stream("stream default, cold", stream(), datasets, launches, dev, k)
    warm, warm_wall, _ = _timed_stream("stream default, warm", stream(), datasets, launches, dev, k)
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
                                                                       minimal_fetch=True), datasets, launches, dev, k)
    for (_, res), r in zip(out, seq):
        assert res.traj_ids == list(r)
        assert np.isnan(res.iod_equinoctial[res.converged]).all(), "minimal: converged rows' IOD columns are NaN"
        for tid, ref_r in r.items():
            _slim_matches(res.result(tid), ref_r, tid)
    _log(f"stream slim+table+minimal: {n} fits in {wall!r} s ({n / wall!r} fits/s); kernel launches {got}")
    return launches, datasets, [res for _, res in out]


def phase_escalating(dev, eph, seeds, stages, seed):
    """Phase 10: fit_lsq_stream_escalating over real-cadence datasets.
    Returns (launches, the first dataset, its ``fit_lsq_escalating``
    results, the stage fits they took)."""
    import numpy as np

    from outfit_tpu_torch import ObsDataset, fit_lsq, fit_lsq_escalating, fit_lsq_stream, fit_lsq_stream_escalating

    datasets = [real_cadence_dataset(N_TRAJ, seed=s)[0] for s in seeds]
    n = sum(len(d.traj_ids) for d in datasets)
    kw = dict(slim_fetch=True, as_table=True, minimal_fetch=True)
    (lean, lean_cfg), (rich, rich_cfg) = stages
    launches = {"body": 0, "frame": 0}
    runs = {}
    # the escalating passes add one cache build: the flush refits the three
    # datasets' failures in one batch
    k = len(datasets)
    for name, fits, run in (
        ("lean tier alone", k,
         lambda: fit_lsq_stream(datasets, eph, lean, lean_cfg, seed, depth=3, device=dev, **kw)),
        ("escalating, cold", k + 1,
         lambda: fit_lsq_stream_escalating(datasets, eph, stages, seed, flush_every=3, depth=3, device=dev, **kw)),
        ("escalating, warm", k + 1,
         lambda: fit_lsq_stream_escalating(datasets, eph, stages, seed, flush_every=3, depth=3, device=dev, **kw)),
    ):
        out, wall, got = _timed_stream(name, run, datasets, launches, dev, fits)
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
    return launches, ds, tiered, 1 + bool(retry0)


def planet_queries(synth):
    """The N-body path's query shapes: 4,096 stage epochs of phase 11's
    lanes and 98,304 of phase 13's (trajectory, observation) lanes, each a
    mid-step stage time ``t0 + 0.5 (t1 - t0)`` in lane order (unsorted
    across lanes, inside one window)."""
    _, t1 = nbody_lanes(N_NBODY, "cpu")
    return {N_NBODY: 57000.0 + 0.5 * (t1.numpy() - 57000.0), len(synth.mjd_tt): 57000.0 + 0.5 * (synth.mjd_tt - 57000.0)}


def phase_kernel_check_planets(dev, eph, synth):
    """Phase 3, extended: K1 against its plain version through every table
    ``NBodyConfig.with_planets()`` queries, at the N-body path's own query
    shapes (:func:`planet_queries`).  The bar is the JAX package's (1e-15
    AU, 1e-16 AU/day) times max(1, the largest distance in AU among the
    plain version's positions): an ulp of Neptune's 30 AU is 3.6e-15 AU.
    Prints per table the deviation, device time, bound, share and the plain
    version's time of one call.  Returns
    the largest position deviation (AU)."""
    import torch

    from outfit_tpu_torch.ephem.bodies import Body
    from outfit_tpu_torch.ephem.chebyshev import interpolate_body, interpolate_body_plain
    from outfit_tpu_torch.propagator import NBodyConfig

    eph_d = eph.to(dev)
    worst = 0.0
    for n, q in planet_queries(synth).items():
        mjd = torch.as_tensor(q, dtype=torch.float64, device=dev)
        for b in NBodyConfig.with_planets().perturbing_bodies[1:]:
            table = eph_d.tables[Body(b)]
            (p, v), (p0, v0) = interpolate_body(table, mjd), interpolate_body_plain(table, mjd)
            scale = max(1.0, torch.sqrt(torch.sum(p0 * p0, -1)).max().item())
            dp, dv = (p - p0).abs().max().item(), (v - v0).abs().max().item()
            if not (dp <= POS_ATOL * scale and dv <= VEL_ATOL * scale):
                raise AssertionError(f"K1 body {Body(b).name} N={n}: deviates from its plain version by {dp!r} AU, "
                                     f"{dv!r} AU/day at scale {scale!r}")
            worst = max(worst, dp)
            ms = device_ms(lambda: interpolate_body(table, mjd))
            plain_ms = _median_ms(lambda: interpolate_body_plain(table, mjd))
            bound, by = k1_bound_ms(n, tuple(table.coeffs.shape), True,
                                    touched_rows(q, table.t0, table.granule_days, table.coeffs.shape[0]))
            _log(f"K1 body {Body(b).name} C={table.coeffs.shape[2]} G={table.coeffs.shape[0]} N={n}: device "
                 f"{1e3 * ms!r} us, bound {1e3 * bound!r} us ({by}), share {bound / ms!r}; plain version "
                 f"{plain_ms!r} ms (median of 20 calls); max|d| {dp!r} AU, {dv!r} AU/day (largest distance "
                 f"{scale!r} AU)")
    return worst


#: an H100 SXM's float32 rate outside the tensor cores, at its 700 W limit
#: (NVIDIA's data sheet)
FP32_FLOP_PER_S = 67e12
FG_KERNEL_SRC = "outfit_tpu_torch/csrc/fg_correction.cuh"
FG_REPLACES = "outfit_tpu/iod/gauss.py:_fg_correction (XLA while_loop, no Pallas kernel)"


def fg_trip_flops():
    """Floating-point operations of one live outer trip of the f-g
    correction kernel, counted from ``csrc/fg_correction.cuh`` with one
    Newton step a side and no Stumpff duplication (the least a trip
    takes): the central state (87), two Kepler solves (set-up 3, a Newton
    step 111, the closing Stumpff evaluation 91, f, g and the velocity 16)
    and the rest of the trip (175).  A lower bound of the work, so the
    share below is one of the kernel's time too."""
    return 87 + 2 * (3 + 111 + 91 + 16) + 175


def fg_bound_ms(n_cand, per, work_bytes, live_trips):
    """(least milliseconds, "bytes" or "operations") of one f-g kernel
    call: each input byte read once and each output byte written once
    (per candidate 14 working-type numbers, an epoch and a flag in; the
    same, a second flag and an int32 count out; per triplet 27 numbers and
    5 float64), against ``live_trips`` x :func:`fg_trip_flops` at the
    working type's rate."""
    n_tri = n_cand // per
    nbytes = n_cand * (2 * (14 * work_bytes + 8 + 1) + 1 + 4) + n_tri * (27 * work_bytes + 5 * 8)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = live_trips * fg_trip_flops() / (FP32_FLOP_PER_S if work_bytes == 4 else FP64_FLOP_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_fg_kernel(dev, eph, synth):
    """Phase 3c: the IOD's f-g correction kernel against its plain version
    on the card, at the stream's shapes: the calls of ``_fg_correction`` in one
    mixed IOD of the stream's profile (the float32 candidate pass and the
    float64 polish) and one float64 IOD over the 8192 x 12 dataset, each
    through the kernel and through ``_fg_correction_plain`` on the same
    inputs.  Flags and the site ``iod_fg``'s trips, live and lanes must be
    identical and every output bitwise (equal, or NaN where the plain
    loop's is NaN); prints the kernel's device time (20
    launches behind a sleep kernel), its bound (:func:`fg_bound_ms`) and
    their ratio, and the plain version's wall (CUDA events, median of 3).
    Returns the ``kernels`` line's numbers per working type."""
    import torch

    from outfit_tpu_torch import IODParams, fit_full_iod, trace
    from outfit_tpu_torch.iod import fg_correction_cuda, gauss

    t = time.perf_counter()
    _, report = fg_correction_cuda.build()
    _log(f"f-g kernel build: {time.perf_counter() - t:.2f} s")
    for line in report.splitlines():
        if "fg_correction_kernel" in line and "Compiling entry" in line:
            _log("  " + line.strip())
        elif "spill" in line or ("registers" in line and "Used" in line):
            _log("  " + line.strip())

    calls = []
    fg = gauss._fg_correction

    def record(*a, **k):
        calls.append((a, k))
        return fg(*a, **k)

    gauss._fg_correction = record
    try:
        for prec in ("mixed", "f64"):
            fit_full_iod(synth, eph, IODParams(n_noise_realizations=3, precision=prec, newton_max_it=20,
                                               max_triplets=2), 7, device=dev)
    finally:
        gauss._fg_correction = fg
    out = {}
    for a, k in calls:
        work = a[5].dtype
        name = str(work).removeprefix("torch.")
        shape = tuple(a[8].shape)
        site = trace.sites.iod_fg

        def counted(fn):
            before = (site.trips, site.live, site.lanes)
            res = fn()
            return res, tuple(x - y for x, y in zip((site.trips, site.live, site.lanes), before))

        got, c_kernel = counted(lambda: gauss._fg_correction(*a, **k))
        ref, c_plain = counted(lambda: gauss._fg_correction_plain(*a, **k))
        if c_kernel != c_plain:
            raise AssertionError(f"f-g kernel {name} {shape}: trips, live, lanes {c_kernel} != plain {c_plain}")
        for label, x, y in zip(("pos", "vel", "epoch", "chi1", "chi2", "alive", "committed"), got, ref):
            if x.dtype != y.dtype or x.shape != y.shape:
                raise AssertionError(f"f-g kernel {name} {shape}: {label} {x.dtype} {tuple(x.shape)} against the "
                                     f"plain version's {y.dtype} {tuple(y.shape)}")
            same = ((x == y) | (torch.isnan(x) & torch.isnan(y))) if x.is_floating_point() else x == y
            if not bool(same.all()):
                raise AssertionError(f"f-g kernel {name} {shape}: {label} differs from the plain version in "
                                     f"{int((~same).sum())} of {same.numel()} numbers")
        # the kernel alone: the wrapper's flat inputs, no summary read
        args, kw = gauss._fg_kernel_inputs(*a, **k)
        ms = device_ms(lambda: fg_correction_cuda.correct(*args, **kw))
        n = args[6].shape[0]
        bound, by = fg_bound_ms(n, n // args[0].shape[0], a[5].element_size(), c_kernel[1])
        plain_ms = _median_ms(lambda: gauss._fg_correction_plain(*a, **k), runs=3)
        _log(f"f-g kernel {name} candidates {shape} ({n}, {n // args[0].shape[0]} a triplet): trips {c_kernel[0]}, "
             f"live share {c_kernel[1] / max(c_kernel[2], 1)!r}; device {1e3 * ms!r} us, bound {1e3 * bound!r} us "
             f"({by}), share {bound / ms!r}; plain version {plain_ms!r} ms (median of 3); every output bitwise")
        if name not in out or n > out[name]["n"]:
            out[name] = dict(n=n, device_ms=ms, bound_ms=bound, bound_by=by, plain_ms=plain_ms)
    return out


STEP_KERNEL_SRC = "outfit_tpu_torch/csrc/lsq_step.cuh"
STEP_REPLACES = "outfit_tpu/lsq/iteration.py:single_iteration (XLA, no Pallas kernel)"


def same_bits(x, y):
    """Equal, NaN where NaN."""
    import torch

    return x.shape == y.shape and bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())


def record_steps(fn):
    """(fn(), the calls of ``single_iteration`` the correction loops made in
    it: (args, kwargs) each)."""
    from outfit_tpu_torch.lsq import loop

    calls, si = [], loop.single_iteration

    def record(*a, **k):
        calls.append((a, k))
        return si(*a, **k)

    loop.single_iteration = record
    try:
        out = fn()
    finally:
        loop.single_iteration = si
    return out, calls


def step_kind(call):
    """A recorded step's working types as the kernel's launch counts name
    them: ``float32``, ``float64_float32`` (float32 Jacobians) or ``float64``."""
    import torch

    a, k = call
    jac = a[7] if len(a) > 7 else k.get("jacobian_dtype")
    if a[0].dtype == torch.float32:
        return "float32"
    return "float64_float32" if jac == torch.float32 else "float64"


def _most(x):
    return float(x.max()) if x.numel() else 0.0


def _ulps(x, y):
    """|x - y| in units in the last place of y."""
    import torch

    return (x - y).abs() / torch.finfo(y.dtype).eps / y.abs().clamp_min(torch.finfo(y.dtype).tiny)


def step_against_plain(call):
    """The two-body step kernel (through ``single_iteration`` on the card)
    against ``_single_iteration_plain`` on the same inputs; raises where
    they part, and returns the largest deviations, for the record.

    Bitwise for every valid observation: residuals, masked partials, the
    active flags; the Kepler state for every slot, padding included.  Per
    trajectory: ``num_measurements`` identical, the covariance bitwise
    ``cholesky_inverse6`` of the kernel's own normal matrix (the kernel
    inverts in its order).  The sums over observations are taken in another
    order than ``torch.sum``'s, each of N terms off by at most (N - 1) eps
    of their absolute sum on either side, so each normal-matrix entry lies
    within 2N eps sqrt(N_ii N_jj) (the weights are positive, so
    Cauchy-Schwarz bounds the absolute sum) and the RMS within N + 1 ulps
    (q's terms are positive; the square root halves it).  With S the normal
    matrix scaled to a unit diagonal, those perturb S by at most 12N eps
    and the scaled right-hand side by 2N eps sqrt(6 q): the inversion's
    verdict may differ only where ||S^-1|| 16N eps >= 1 (an eigenvalue
    within the perturbation of zero: singular at the working precision,
    as ~20 % of the float32 pre-warm's short arcs are), and where both
    sides inverted, the scaled correction and its norm stay within the
    first-order bound 16N ||S^-1|| eps (||y|| + sqrt(q)), the norm's times
    sqrt(||S||) (12N from the sums, 4N for the two solves' own rounding;
    Frobenius norms bound the spectral ones)."""
    import torch

    from outfit_tpu_torch.lsq import iteration
    from outfit_tpu_torch.utils.linalg import cholesky_inverse6

    a, k = call
    got = iteration.single_iteration(*a, **k)
    ref = iteration._single_iteration_plain(*a, **k)
    valid = a[3].valid
    for name in ("residual_ra", "residual_dec", "obs_active", "d_ra", "d_dec"):
        x, y = getattr(got, name), getattr(ref, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert same_bits(x[valid], y[valid]), (name, int((x[valid] != y[valid]).sum()))
    assert same_bits(got.kepler, ref.kepler), int((got.kepler != ref.kepler).sum())
    assert torch.equal(got.num_measurements, ref.num_measurements)
    eye = torch.eye(6, dtype=got.normal_matrix.dtype, device=valid.device)
    finite = torch.isfinite(got.normal_matrix).all(-1).all(-1)
    cov, _ = cholesky_inverse6(torch.where(finite[:, None, None], got.normal_matrix, eye))
    assert same_bits(got.covariance[got.inversion_ok], cov[got.inversion_ok])

    eps = torch.finfo(got.corrected.dtype).eps
    n = valid.shape[1]
    # the normal matrix scaled to a unit diagonal, S = D^-1/2 N D^-1/2, and
    # its inverse D^1/2 C D^1/2 from whichever side inverted it
    both = got.inversion_ok & ref.inversion_ok
    one = got.inversion_ok ^ ref.inversion_ok
    cov_any = torch.where(got.inversion_ok[:, None, None], got.covariance, ref.covariance)
    d = torch.diagonal(ref.normal_matrix, dim1=-2, dim2=-1).clamp_min(torch.finfo(got.corrected.dtype).tiny)
    sd = d.sqrt()
    outer = sd[:, :, None] * sd[:, None, :]
    s_norm = (ref.normal_matrix / outer).flatten(1).norm(dim=1)
    sinv_norm = (cov_any * outer).flatten(1).norm(dim=1)
    q = ref.normalised_rms ** 2 * ref.num_measurements
    y = sd * (ref.corrected - a[0])
    unit = sinv_norm * eps * (y.norm(dim=1) + q.sqrt())
    dy = sd * (got.corrected - ref.corrected).abs() - 2 * eps * sd * a[0].abs()
    cn = (got.correction_norm - ref.correction_norm).abs()
    nm, nr = got.normal_matrix[both], ref.normal_matrix[both]
    seen = dict(
        rows=int(valid.shape[0]), both=int(both.sum()), disagree=int(one.sum()),
        disagree_min_sinv_eps=float((sinv_norm * eps)[one].min()) if one.any() else 0.0,
        normal_eps=_most((nm - nr).abs() / outer[both]) / eps,
        rms_ulps=_most(_ulps(got.normalised_rms[both], ref.normalised_rms[both])),
        dy_units=_most((dy.amax(dim=1) / unit)[both]),
        cn_units=_most((cn / (s_norm.sqrt() * unit))[both]),
        sinv_eps_max=_most((sinv_norm * eps)[both]),
    )
    singular = sinv_norm * 16 * n * eps >= 1
    assert bool((singular | ~one).all()), seen
    assert seen["normal_eps"] <= 2 * n and seen["rms_ulps"] <= n + 1, seen
    assert bool((dy.amax(dim=1) <= 16 * n * unit)[both].all()), seen
    assert bool((cn <= 16 * n * s_norm.sqrt() * unit)[both].all()), seen
    return seen


def step_bound_ms(args, out):
    """Least milliseconds of one step kernel call: every byte of its inputs
    (the warm start's three views included) read once and of its outputs
    written once, over the H100's 3.35 TB/s."""
    nbytes = sum(x.numel() * x.element_size() for x in (*args, *out) if x is not None)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def phase_step_kernel(dev, eph, synth, ds, picks, stream_profile):
    """Phase 3d: the correction's two-body Newton step kernel against its
    plain version on the card, at the main path's shapes: every step of a
    mixed fit of the stream's profile on the 8192 x 12 dataset (the float32
    pre-warm, the mixed main loop, the float64 final linearisation) and of
    phase 4's seeded float64 fit (4096 x 129), each held by
    :func:`step_against_plain`.  For the last step of each working type and
    shape: the kernel's device time (20 launches behind a sleep kernel),
    its bound (:func:`step_bound_ms`) and their ratio, and the plain step's
    wall (CUDA events, median of 3: it reads the device once a Kepler
    trip).  Returns the ``kernels`` line's numbers per working type, at its
    largest shape."""
    from outfit_tpu_torch import DifferentialCorrectionConfig, fit_lsq
    from outfit_tpu_torch.lsq import iteration, step_cuda

    t = time.perf_counter()
    _, report = step_cuda.build()
    _log(f"step kernel build: {time.perf_counter() - t:.2f} s")
    for line in report.splitlines():
        if "lsq_step_kernel" in line and "Compiling entry" in line:
            _log("  " + line.strip())
        elif "spill" in line or ("registers" in line and "Used" in line):
            _log("  " + line.strip())

    iod, cfg = stream_profile
    shapes = {
        "stream": record_steps(lambda: fit_lsq(synth, eph, iod, cfg, 7, device=dev))[1],
        "seeded": record_steps(lambda: fit_lsq(ds, eph, config=DifferentialCorrectionConfig(),
                                               initial_orbits=seeds_for(ds, picks), device=dev))[1],
    }
    out = {}
    for shape, calls in shapes.items():
        last, worst = {}, {}
        for c in calls:
            name = step_kind(c)
            last[name] = c
            seen = step_against_plain(c)
            w = worst.setdefault(name, dict(steps=0, disagree=0))
            w["steps"] += 1
            w["disagree"] = max(w["disagree"], seen["disagree"])
            for key in ("normal_eps", "rms_ulps", "dy_units", "cn_units"):
                w[key] = max(w.get(key, 0.0), seen[key])
        for name, (a, k) in sorted(last.items()):
            args, kw = iteration._step_kernel_inputs(*a[:5], a[7] if len(a) > 7 else k.get("jacobian_dtype"),
                                                     k.get("kepler_warm"))
            ms = device_ms(lambda: step_cuda.step(*args, **kw))
            bound = step_bound_ms(args, step_cuda.step(*args, **kw))
            plain_ms = _median_ms(lambda: iteration._single_iteration_plain(*a, **k), runs=3)
            T, N = a[3].mjd.shape
            _log(f"step kernel {name} {shape} {T} x {N}: {worst[name]} (largest over its steps: rows whose inversion "
                 f"verdict differs, normal entries in eps of sqrt(N_ii N_jj), RMS ulps, correction and norm in units "
                 f"of their bound); device {1e3 * ms!r} us, bound {1e3 * bound!r} us (bytes), share {bound / ms!r}; "
                 f"plain step {plain_ms!r} ms (median of 3); every valid observation bitwise")
            if name not in out or T * N > out[name]["n"]:
                out[name] = dict(n=T * N, device_ms=ms, bound_ms=bound, bound_by="bytes", plain_ms=plain_ms)
    if set(out) != set(step_cuda.launches):
        raise AssertionError(f"step kernel: working types {sorted(out)} recorded, want {sorted(step_cuda.launches)}")
    return out


class counted:
    """Counts the calls of ``module.name`` inside the ``with`` block, and
    the host seconds spent in them."""

    def __init__(self, module, name):
        self.module, self.name, self.calls, self.seconds = module, name, 0, 0.0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapper(*a, **k):
            self.calls += 1
            t = time.perf_counter()
            try:
                return self.orig(*a, **k)
            finally:
                self.seconds += time.perf_counter() - t

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _timed(fn, dev):
    t = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t


def _tally(total):
    """Add the kernel's launch counts since the last reset to ``total`` and
    return them."""
    from outfit_tpu_torch.ephem import chebyshev_cuda

    got = dict(chebyshev_cuda.launches)
    for site in total:
        total[site] += got[site]
    return got


def _peak_gb():
    import torch

    return torch.cuda.max_memory_allocated() / 2**30


def nbody_lanes(n, dev):
    """bench.py:684-739's lanes: random bound orbits at epoch 57000 and
    their arcs of 25 to 30 days, in the bench's order of draws."""
    import numpy as np
    import torch

    from outfit_tpu_torch.elements.types import EquinoctialElements

    rng = np.random.default_rng(3)
    a = rng.uniform(1.2, 3.5, n)
    e = rng.uniform(0.0, 0.35, n)
    pom = rng.uniform(0, 2 * np.pi, n)
    om = rng.uniform(0, 2 * np.pi, n)
    tani2 = np.tan(rng.uniform(0.0, 0.3, n))
    cols = [np.full(n, 57000.0), a, e * np.sin(pom), e * np.cos(pom), tani2 * np.sin(om), tani2 * np.cos(om),
            rng.uniform(0, 2 * np.pi, n)]
    t1 = 57000.0 + rng.uniform(25.0, 30.0, n)
    f64 = dict(dtype=torch.float64, device=dev)
    return EquinoctialElements(*(torch.as_tensor(c, **f64) for c in cols)), torch.as_tensor(t1, **f64)


def phase_nbody(dev, eph):
    """Phase 11: N-body propagation of 4,096 lanes over 25-30 days."""
    import numpy as np
    import torch

    from outfit_tpu_torch import NBodyConfig, Ut1Provider, dop853_integrate, propagate_nbody
    from outfit_tpu_torch.elements.twobody import propagate_twobody
    from outfit_tpu_torch.elements.types import KeplerianElements, keplerian_to_equinoctial
    from outfit_tpu_torch.ephem import chebyshev_cuda
    from outfit_tpu_torch.observer.geometry import gast
    from outfit_tpu_torch.propagator import nbody

    eq, t1 = nbody_lanes(N_NBODY, dev)
    eph_cpu, eph = eph, eph.to(dev)  # the tables resident on the card, as the lanes are
    planets = NBodyConfig.with_planets()
    launches = {"body": 0, "frame": 0}
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for mode, cfg in (("frozen", planets),
                      ("moving", NBodyConfig(perturbing_bodies=planets.perturbing_bodies, frozen_perturbers=False))):
        run = lambda: propagate_nbody(eq, t1, eph, cfg)
        chebyshev_cuda.reset_launch_counts()
        # thirteen right-hand sides per loop trip
        with counted(nbody, "_acceleration_and_gradient") as rhs:
            res, cold = _timed(run, dev)
        got = _tally(launches)
        trips, rem = divmod(rhs.calls, 13)
        want = {"body": 9 if mode == "frozen" else 9 * 13 * trips, "frame": 0}
        if rem or got != want:
            raise AssertionError(f"N-body {mode}: {rhs.calls} right-hand sides, kernel launches {got}, expected {want} "
                                 f"(9 planet tables per perturber evaluation: one at t0, or 13 per trip)")
        chebyshev_cuda.reset_launch_counts()
        # the host's time inside the kernel's wrapper (its launches do not
        # wait for the card)
        with counted(chebyshev_cuda, "evaluate") as k1:
            res_w, warm = _timed(run, dev)
        _tally(launches)
        if not (res.status == 0).all():
            raise AssertionError(f"N-body {mode}: {int((res.status != 0).sum())} lanes failed")
        for f in res._fields:
            if not torch.equal(getattr(res, f), getattr(res_w, f)):
                raise AssertionError(f"N-body {mode}: cold and warm runs differ in {f}")
        steps = int(res.n_steps.sum())
        _, wall, busy, n_launch, top = _profiled(run, dev, n_top=None)
        k1_us = sum(e.self_device_time_total for e in top if "chebyshev" in e.key)
        syncs = count_syncs(run)
        _log(f"N-body {mode}: {N_NBODY} lanes, {steps} accepted steps (per lane {int(res.n_steps.min())}-"
             f"{int(res.n_steps.max())}), {trips} trips, kernel launches {got}; cold {cold!r} s, warm {warm!r} s, "
             f"{steps / warm!r} accepted steps/s; profiled {wall!r} s, device busy {busy!r} s "
             f"({100.0 * busy / wall:.1f} %), {n_launch} kernels and copies ({n_launch / trips:.0f} per trip), "
             f"{syncs} host syncs; K1 device time {k1_us / 1e6!r} s ({100.0 * k1_us / 1e6 / max(busy, 1e-12):.1f} % of "
             f"busy), host time in its wrapper {k1.seconds!r} s ({100.0 * k1.seconds / warm:.1f} % of the warm wall)")
        for e in top[:6]:
            _log(f"    {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:6d}  {e.key[:90]}")
        out[mode] = res
    # over two days the perturbers barely move: the JAX suite's bar (5e-10
    # AU, tests/test_propagator.py::test_short_arc_matches_frozen) on its
    # own main-belt orbit, and on the bench's lanes at the median (a lane
    # that passes a planet feels the planet's two days of motion); over the
    # 25 to 30 days they do move, which is what the moving mode is for
    d30 = (out["frozen"].position - out["moving"].position).abs().max().item()
    f64 = dict(dtype=torch.float64, device=dev)
    belt = keplerian_to_equinoctial(KeplerianElements(*(torch.as_tensor(x, **f64) for x in JAX_TEST_ORBIT)))
    chebyshev_cuda.reset_launch_counts()
    d2 = []
    for q in (belt, eq):
        a, b = (propagate_nbody(q, 57002.0, eph, NBodyConfig(perturbing_bodies=planets.perturbing_bodies,
                                                             frozen_perturbers=f)) for f in (True, False))
        if not ((a.status == 0).all() and (b.status == 0).all()):
            raise AssertionError("N-body: a 2-day arc failed")
        d2.append((a.position - b.position).abs().amax(dim=-1).reshape(-1))
    _tally(launches)
    d, d_med, d_max = d2[0].item(), d2[1].median().item(), d2[1].max().item()
    if not (d <= 5e-10 and d_med <= 5e-10):
        raise AssertionError(f"N-body: frozen and moving perturbers differ by {d!r} AU on the main-belt orbit, "
                             f"{d_med!r} AU at the lanes' median, over 2 days (bar 5e-10)")
    sun = propagate_nbody(eq, t1, eph, NBodyConfig())
    tb = propagate_twobody(eq, 57000.0, t1)
    dp, dv = (sun.position - tb.position).abs().max().item(), (sun.velocity - tb.velocity).abs().max().item()
    dj = (sun.dpos_delem - tb.dpos_delem).abs().max().item()
    if not (dp <= 1e-11 and dv <= 1e-12 and (sun.status == 0).all()):
        raise AssertionError(f"Sun-only N-body against two-body: {dp!r} AU, {dv!r} AU/day")
    # host inputs (a fit result carries its elements as CPU tensors, a
    # catalogue as numpy arrays) with a host ephemeris and no device named:
    # on the card all the same
    eq_np = type(eq)(*(f[:N_CHECK].cpu().numpy() for f in eq))
    chebyshev_cuda.reset_launch_counts()
    from_np = propagate_nbody(eq_np, t1[:N_CHECK].cpu(), eph_cpu, planets)
    d_np = (from_np.position - out["frozen"].position[:N_CHECK]).abs().max().item()
    decay = dop853_integrate(lambda t, y: -y, np.ones((N_CHECK, 1)), 0.0, 1.0)
    if not (from_np.position.is_cuda and _tally(launches) == {"body": 9, "frame": 0} and d_np <= 1e-12
            and decay.y.is_cuda and gast(np.array([57000.5]), Ut1Provider()).is_cuda
            and abs(decay.y[0, 0].item() - np.exp(-1.0)) <= 1e-11):
        raise AssertionError(f"numpy inputs with no device named did not run on the card ({d_np!r} AU from the lanes' batch)")
    worst = {}
    eq_c, t1_c = nbody_lanes(N_NBODY, "cpu")
    eq_c = type(eq_c)(*(f[:N_CHECK] for f in eq_c))
    for mode, res in out.items():
        cfg = NBodyConfig(perturbing_bodies=planets.perturbing_bodies, frozen_perturbers=mode == "frozen")
        ref = propagate_nbody(eq_c, t1_c[:N_CHECK], eph_cpu, cfg, device="cpu")
        worst[mode] = (res.position[:N_CHECK].cpu() - ref.position).abs().max().item()
        dn = (res.n_steps[:N_CHECK].cpu() - ref.n_steps).abs().max().item()
        if not (worst[mode] <= 1e-10 and (ref.status == 0).all() and dn <= 2):
            raise AssertionError(f"N-body {mode} card vs CPU: {worst[mode]!r} AU, n_steps apart by {dn}")
    _log(f"N-body: frozen vs moving over 2 days {d!r} AU on the JAX suite's main-belt orbit, lanes median {d_med!r}, "
         f"max {d_max!r} AU ({d30!r} AU over the 25-30 days); Sun-only vs two-body {dp!r} AU, {dv!r} AU/day, partials {dj!r}; "
         f"card vs CPU on {N_CHECK} lanes {worst}; peak memory {_peak_gb():.3f} GiB")
    return launches


def _wrapped(a, b):
    """|a - b| of two angles, wrapped to [0, pi]."""
    import numpy as np

    return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)


def _on_sky(a, b, ok):
    """Largest separation (rad) of two tables' apparent positions over the
    entries ``ok``, per axis on the sky: the right-ascension difference
    times cos(dec) (near a pole a right ascension alone magnifies any
    rounding by 1 / cos(dec)) and the declination difference."""
    import numpy as np

    return np.maximum(_wrapped(a.ra[ok], b.ra[ok]) * np.cos(b.dec[ok]), np.abs(a.dec[ok] - b.dec[ok]))


def phase_ephemeris(dev, eph, results, table9):
    """Phase 12: ephemeris generation end to end."""
    import numpy as np
    import torch

    from outfit_tpu_torch import (
        AberrationOrder, EphemerisConfig, EphemerisMode, EphemerisRequest, NBodyConfig, Observer, PropagatorKind,
        compute_ephemerides_batch, compute_ephemeris, get_observatory,
    )
    from outfit_tpu_torch.elements.types import EquinoctialElements
    from outfit_tpu_torch.ephem import chebyshev_cuda

    def request(order=AberrationOrder.FIRST, propagator=PropagatorKind.two_body()):
        # inside the fits' 40-day window: arcs the frozen perturbers serve
        grid = EphemerisMode.range(57004.0, 57035.0, 1.0)
        return (EphemerisRequest(EphemerisConfig(propagator=propagator, aberration=order))
                .add(Observer.geocenter(), grid).add(get_observatory("809"), grid))

    launches = {"body": 0, "frame": 0}
    torch.cuda.reset_peak_memory_stats()
    T, P = len(results), len(request())
    assert P == 64

    def batch(res, req, device=dev, body=2):
        chebyshev_cuda.reset_launch_counts()
        table, wall = _timed(lambda: compute_ephemerides_batch(res, req, eph, device=device), device)
        got = _tally(launches) if torch.device(device).type == "cuda" else None
        if got is not None and got != {"body": body, "frame": 0}:
            raise AssertionError(f"ephemeris batch: kernel launches {got}, expected {body} at the body site")
        return table, wall

    def check(table, tag):
        live = len(table) - len(table.row_errors)
        if int(table.ok.sum()) != live * P or table.ok.shape != (len(table), P):
            raise AssertionError(f"{tag}: {int(table.ok.sum())} ok entries, expected {live} live rows x {P}")
        ok = table.ok
        if not ((table.ra[ok] >= 0).all() and (table.ra[ok] < 2 * np.pi).all() and (np.abs(table.dec[ok]) <= np.pi / 2).all()
                and all((getattr(table, f)[ok] >= 0).all() and (getattr(table, f)[ok] <= np.pi).all()
                        for f in ("phase_angle", "solar_elongation"))
                and all(np.isfinite(getattr(table, f)[ok]).all() for f in ("geocentric_distance", "radial_velocity",
                                                                          "d_ra_dt", "d_dec_dt"))):
            raise AssertionError(f"{tag}: an angle out of range or a value not finite")
        return live

    tables = {}
    for name, req in (("first", request()), ("second", request(AberrationOrder.SECOND))):
        tables[name], cold = batch(results, req)
        _, warm = batch(results, req)
        live = check(tables[name], name)
        _log(f"ephemeris {name} order: {T} rows x {P} pairs = {T * P} entries, {live} live rows "
             f"({len(tables[name].row_errors)} row errors), cold {cold!r} s ({T * P / cold!r} entries/s), warm {warm!r} s "
             f"({T * P / warm!r} entries/s), 2 body launches per call")
    first, second = tables["first"], tables["second"]
    ok = first.ok
    if not np.array_equal(first.ok, second.ok):
        raise AssertionError("first and second order aberration: different ok entries")
    sep12 = np.zeros(ok.shape)
    sep12[ok] = _on_sky(first, second, ok)
    row12 = sep12.max(axis=1)
    # the bars on the physics hold for the orbits the correction converged
    # onto their observations (normalised RMS <= 2); a row that fell back to
    # its IOD orbit, or converged far from its observations, may carry any
    # orbit the limits let through (a = 0.23 AU at e = 0.99, or one 0.015 AU
    # from the Earth, among them)
    fitted = np.array([results[t].ok and not results[t].fell_back_to_iod and results[t].normalised_rms <= 2.0
                       for t in first.traj_ids])
    d12 = float(row12[fitted].max())
    over = np.flatnonzero(row12 > 1e-6)

    def describe(i, what):
        r = results[first.traj_ids[i]]
        _log(f"    {first.traj_ids[i]}: {what}; a {float(r.equinoctial[0])!r}, e "
             f"{float(np.hypot(r.equinoctial[1], r.equinoctial[2]))!r}, least distance "
             f"{float(first.geocentric_distance[i][ok[i]].min())!r} AU, nRMS {r.normalised_rms!r}, "
             f"fell back to the IOD orbit {r.fell_back_to_iod}")

    for i in over[np.argsort(-row12[over])][:4]:
        describe(i, f"aberration orders {float(row12[i])!r} rad apart")
    if not 0 < d12 <= 1e-6:
        raise AssertionError(f"first and second order aberration differ by {d12!r} rad on a fitted orbit")
    _, wall, busy, n_launch, top = _profiled(lambda: compute_ephemerides_batch(results, request(), eph, device=dev), dev)
    syncs = count_syncs(lambda: compute_ephemerides_batch(results, request(), eph, device=dev))
    _log(f"  profiled warm first-order call: wall {wall!r} s, device busy {busy!r} s ({100.0 * busy / wall:.1f} %), "
         f"{n_launch} kernels and copies, {syncs} host syncs; first vs second order on {int(fitted.sum())} fitted orbits at "
         f"most {d12!r} rad, row median {float(np.median(row12[fitted]))!r}; over all live rows {float(row12.max())!r}, "
         f"{len(over)} rows over 1e-6")
    for e in top[:4]:
        _log(f"    {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:6d}  {e.key[:90]}")

    # phase 9's columnar table, taken column-wise
    tab, cold = batch(table9, request())
    _, warm = batch(table9, request())
    live = check(tab, "LsqTable input")
    _log(f"ephemeris from an LsqTable: {len(tab)} rows, {live} live, cold {cold!r} s, warm {warm!r} s "
         f"({len(tab) * P / warm!r} entries/s)")

    # per-orbit API on the card, 8 live rows
    live_ids = [t for t in first.traj_ids if t not in first.row_errors]
    worst = 0.0
    for tid in live_ids[:8]:
        r = results[tid]
        eq = EquinoctialElements(*(torch.as_tensor(x, dtype=torch.float64) for x in (r.epoch, *r.equinoctial)))
        chebyshev_cuda.reset_launch_counts()
        per = compute_ephemeris(eq, request(), eph, device=dev)
        if _tally(launches) != {"body": 2, "frame": 0}:
            raise AssertionError("compute_ephemeris: expected 2 kernel launches at the body site")
        row = first.result(tid)
        for a, b in zip(per, row):
            assert a.ok and b.ok and a.epoch == b.epoch, (tid, a.error, b.error)
            va, vb = np.array([*a.value.position, *a.value.geometry]), np.array([*b.value.position, *b.value.geometry])
            worst = max(worst, float(np.abs(va - vb).max()))
    if not worst <= 1e-13:
        raise AssertionError(f"batch against the per-orbit API: {worst!r} > 1e-13")

    # card against CPU, 64 rows
    head_res = {t: results[t] for t in first.traj_ids[:N_CHECK]}
    cpu, _ = batch(head_res, request(), device="cpu")
    assert np.array_equal(cpu.ok, first.ok[:N_CHECK])
    okc = cpu.ok
    head_tab = types.SimpleNamespace(ra=first.ra[:N_CHECK], dec=first.dec[:N_CHECK])
    dev_cpu = max(float(_on_sky(head_tab, cpu, okc).max()),
                  *(float(np.abs(getattr(first, f)[:N_CHECK][okc] - getattr(cpu, f)[okc]).max())
                    for f in ("phase_angle", "solar_elongation")))
    if not dev_cpu <= 1e-12:
        raise AssertionError(f"ephemeris card vs CPU: {dev_cpu!r} rad > 1e-12")

    # the N-body propagator on the first 512 rows against two-body
    sub = {t: results[t] for t in first.traj_ids[:512]}
    nb, nb_wall = batch(sub, request(propagator=PropagatorKind.n_body(NBodyConfig.with_planets())), body=2 + 9)
    okn = nb.ok
    assert np.array_equal(okn, first.ok[:512])
    sep_nb = np.zeros(okn.shape)
    sep_nb[okn] = _on_sky(nb, types.SimpleNamespace(ra=first.ra[:512], dec=first.dec[:512]), okn)
    row_nb = sep_nb.max(axis=1)
    sep = sep_nb[fitted[:512]][okn[fitted[:512]]]
    describe(int(np.argmax(np.where(fitted[:512], row_nb, 0.0))), f"N-body {float(row_nb[fitted[:512]].max())!r} rad "
             f"from two-body, the most among fitted orbits")
    _log(f"  batch vs per-orbit API on 8 rows {worst!r}; card vs CPU on {N_CHECK} rows {dev_cpu!r} rad; N-body vs "
         f"two-body on 512 rows x {P} pairs ({nb_wall!r} s, 2 + 9 body launches), {int(fitted[:512].sum())} fitted "
         f"orbits: median {float(np.median(sep))!r}, p99 {float(np.percentile(sep, 99))!r}, max {float(sep.max())!r} "
         f"rad (all live rows: {float(row_nb.max())!r}); peak memory {_peak_gb():.3f} GiB")
    if not float(sep.max()) <= 1e-5:
        raise AssertionError("ephemeris: the N-body propagator is over 1e-5 rad from two-body on a fitted orbit")
    return launches


def phase_nbody_correction(dev, eph, ds, params, results, summ6):
    """Phase 13: the correction with the N-body propagator, seeded with
    phase 6's orbits."""
    import numpy as np
    import torch

    from outfit_tpu_torch import DifferentialCorrectionConfig, FitResult, NBodyConfig, PropagatorKind, fit_lsq
    from outfit_tpu_torch.ephem import chebyshev_cuda
    from outfit_tpu_torch.lsq import iteration
    from outfit_tpu_torch.propagator import nbody

    cfg = DifferentialCorrectionConfig(propagator=PropagatorKind.n_body(NBodyConfig.with_planets()),
                                       divergence_grace_iterations=2, max_newton_iterations=4)
    # the orbits the two-body correction converged.  A row that fell back to
    # its IOD orbit is left out (it fails here as a row with no seed): such
    # orbits reach e = 0.99 at a = 0.23 AU, the integrator needs hundreds of
    # steps through their perihelia, and every trip advances all lanes
    seeds = {tid: FitResult(tid, ok=r.ok, error=r.error, rms=r.normalised_rms, epoch=r.epoch, equinoctial=r.equinoctial)
             for tid, r in results.items() if r.ok and not r.fell_back_to_iod}
    run = lambda: fit_lsq(ds, eph, params, cfg, initial_orbits=seeds, device=dev)
    launches = {"body": 0, "frame": 0}
    torch.cuda.reset_peak_memory_stats()
    chebyshev_cuda.reset_launch_counts()
    with counted(nbody, "_acceleration_and_gradient") as rhs, counted(iteration, "observation_partials") as newton:
        res, cold = _timed(run, dev)
    got = _tally(launches)
    want = {"body": 2 + 9 * newton.calls, "frame": 1}
    if got != want or rhs.calls % 13:
        raise AssertionError(f"N-body correction: kernel launches {got}, expected {want} (one cache build and "
                             f"{newton.calls} propagations of 9 planet tables)")
    chebyshev_cuda.reset_launch_counts()
    res_w, warm = _timed(run, dev)
    _tally(launches)
    for tid in ds.traj_ids:
        if not _same_fit(res[tid], res_w[tid], covariance=True):
            raise AssertionError(f"{tid}: cold and warm N-body corrections differ")
    summ = _summary(res)
    frac, frac6 = summ["converged"] / summ["total"], summ6["converged"] / summ6["total"]
    prof = []
    syncs = count_syncs(lambda: prof.append(_profiled(run, dev)))  # one fit serves both
    _, wall, busy, n_launch, top = prof[0]
    conv_trips_per_step = rhs.calls / 13 / newton.calls
    _log(f"N-body correction: {len(seeds)} of {len(ds.traj_ids)} trajectories seeded x {N_SYNTH_OBS} observations, cold {cold!r} s, warm "
         f"{warm!r} s; {newton.calls} Newton steps, {rhs.calls // 13} trips ({rhs.calls / 13 / newton.calls:.1f} per "
         f"step), kernel launches {got}; profiled {wall!r} s, device busy {busy!r} s ({100.0 * busy / wall:.1f} %), "
         f"{n_launch} kernels and copies, {syncs} host syncs; peak memory {_peak_gb():.3f} GiB")
    for e in top:
        _log(f"    {e.self_device_time_total / 1e3:10.3f} ms  x{e.count:6d}  {e.key[:90]}")
    _log(f"N-body correction outcome: {summ}; converged fraction {frac!r} vs two-body (phase 6) {frac6!r}")
    if not abs(frac - frac6) <= 0.02:
        raise AssertionError("N-body correction: converged fraction more than 0.02 from the two-body fit's")
    # the planets move a 12-observation 40-day fit inside its flat
    # chi-squared valley: by a fraction of its formal uncertainty, not by
    # 1e-4 of the elements
    conv = lambda r: r.ok and not r.fell_back_to_iod
    both = [t for t, r in res.items() if conv(r) and conv(results[t])]
    dev_el = lambda a, b: np.abs(a.equinoctial - b.equinoctial)
    rel = np.array([np.max(dev_el(res[t], results[t]) / (1e-2 + np.abs(results[t].equinoctial))) for t in both])
    sig = np.array([np.max(dev_el(res[t], results[t]) / results[t].uncertainties) for t in both])
    _log(f"  elements against the two-body fit (phase 6) on {len(both)} rows converged in both: relative to 0.01 + "
         f"|element| median {float(np.median(rel))!r}, p99 {float(np.percentile(rel, 99))!r}, max {float(rel.max())!r}; "
         f"in the two-body fit's 1-sigma uncertainties median {float(np.median(sig))!r}, p99 "
         f"{float(np.percentile(sig, 99))!r}, max {float(sig.max())!r}")
    if not (float(np.median(sig)) <= NBODY_FIT_SIGMA[0] and float(np.percentile(sig, 99)) <= NBODY_FIT_SIGMA[1]):
        raise AssertionError("N-body correction: too many sigma from the two-body fit")
    # the same dynamics through both propagators: the Sun-only N-body
    # correction against the two-body correction, from the same orbits
    sun_cfg = dataclasses.replace(cfg, propagator=PropagatorKind.n_body(NBodyConfig()))
    two_cfg = dataclasses.replace(cfg, propagator=PropagatorKind.two_body())
    chebyshev_cuda.reset_launch_counts()
    sun, sun_wall = _timed(lambda: fit_lsq(ds, eph, params, sun_cfg, initial_orbits=seeds, device=dev), dev)
    two, _ = _timed(lambda: fit_lsq(ds, eph, params, two_cfg, initial_orbits=seeds, device=dev), dev)
    if _tally(launches) != {"body": 4, "frame": 2}:
        raise AssertionError("the Sun-only N-body correction looks up no planet table: two cache builds only")
    changed = [t for t in sun if (sun[t].ok, sun[t].status, sun[t].fell_back_to_iod) !=
               (two[t].ok, two[t].status, two[t].fell_back_to_iod)]
    both = [t for t in sun if t not in changed and conv(sun[t])]
    rel = np.array([np.max(dev_el(sun[t], two[t]) / (1e-2 + np.abs(two[t].equinoctial))) for t in both])
    _log(f"  Sun-only N-body correction ({sun_wall!r} s) against the two-body correction from the same orbits: "
         f"{len(changed)} rows with another outcome, {len(both)} converged in both, elements relative to 0.01 + "
         f"|element| median {float(np.median(rel))!r}, max {float(rel.max())!r}")
    if not (len(changed) <= NBODY_FIT_CHANGED and float(rel.max()) <= 1e-4):
        raise AssertionError("Sun-only N-body correction: over 1e-4 from the two-body correction")
    sub = head(ds, N_CHECK)
    sub_seeds = {t: seeds[t] for t in sub.traj_ids if t in seeds}
    rg = fit_lsq(sub, eph, params, cfg, initial_orbits=sub_seeds, device=dev)
    rc = fit_lsq(head(ds, N_CHECK), eph, params, cfg, initial_orbits=sub_seeds, device="cpu")
    worst = 0.0
    for tid in sub.traj_ids:
        a, b = rc[tid], rg[tid]
        if (a.ok, a.status, a.fell_back_to_iod) != (b.ok, b.status, b.fell_back_to_iod):
            raise AssertionError(f"{tid}: N-body correction differs card/CPU: {a.status} vs {b.status}")
        if a.ok:
            np.testing.assert_allclose(b.equinoctial, a.equinoctial, rtol=1e-6, atol=1e-9, err_msg=tid)
            worst = max(worst, float(np.max(np.abs(b.equinoctial - a.equinoctial))))
    apart = sum(not _same_fit(rg[tid], res[tid]) for tid in sub.traj_ids)
    _log(f"  card vs CPU, {N_CHECK} trajectories: same outcomes, max |d elements| {worst!r}; {apart} of the "
         f"{N_CHECK} rows differ bitwise from their rows in the full batch")

    # what an unseeded N-body fit hands its correction: every ok orbit of
    # phase 6 on the first trajectories, the IOD-fallback orbits among them
    # (up to e = 0.99 at a = 0.23 AU).  Their lanes take hundreds of steps
    # through a perihelion and every loop trip advances all lanes, so the
    # trips per Newton step are the stragglers'
    part = head(ds, N_NBODY_FIT_ALL)
    seeds_all = {tid: FitResult(tid, ok=True, rms=results[tid].normalised_rms, epoch=results[tid].epoch,
                                equinoctial=results[tid].equinoctial) for tid in part.traj_ids if results[tid].ok}
    n_fell = sum(results[tid].fell_back_to_iod for tid in seeds_all)
    torch.cuda.reset_peak_memory_stats()
    chebyshev_cuda.reset_launch_counts()
    with counted(nbody, "_acceleration_and_gradient") as rhs, counted(iteration, "observation_partials") as newton:
        res_all, wall_all = _timed(lambda: fit_lsq(part, eph, params, cfg, initial_orbits=seeds_all, device=dev), dev)
    got = _tally(launches)
    want = {"body": 2 + 9 * newton.calls, "frame": 1}
    trips_all = rhs.calls // 13
    if got != want or rhs.calls % 13 or trips_all > newton.calls * cfg.propagator.config.max_steps:
        raise AssertionError(f"N-body correction, every ok orbit seeded: kernel launches {got}, expected {want}; "
                             f"{trips_all} trips in {newton.calls} propagations of at most "
                             f"{cfg.propagator.config.max_steps} each")
    summ_all = _summary(res_all)
    frac_all = summ_all["converged"] / summ_all["total"]
    conv6 = sum(r.ok and not r.fell_back_to_iod and r.status == 1 for r in (results[t] for t in part.traj_ids))
    frac6_all = conv6 / len(part.traj_ids)
    _log(f"N-body correction, first {len(part.traj_ids)} trajectories, every ok orbit of phase 6 seeded ({len(seeds_all)}, "
         f"{n_fell} of them IOD fallbacks): one fit {wall_all!r} s; {newton.calls} Newton steps, {trips_all} trips "
         f"({trips_all / newton.calls:.1f} per step, {trips_all / newton.calls / conv_trips_per_step:.1f}x "
         f"the converged seeds'), kernel launches {got}; outcome {summ_all}; converged fraction {frac_all!r} vs "
         f"two-body (phase 6, the same rows) {frac6_all!r}; peak memory {_peak_gb():.3f} GiB")
    if not (n_fell > 0 and abs(frac_all - frac6_all) <= 0.02):
        raise AssertionError("N-body correction, every ok orbit seeded: converged fraction more than 0.02 from the "
                             "two-body fit's on the same rows")
    return launches


#: phase 14: DE440's span, JD 2287184.5 to 2688976.5 as MJD, in 32-day blocks
DE440_SPAN, DE440_BLOCK_DAYS = (-112816.0, 288976.0), 32.0
#: phase 14: per NAIF body id, (subintervals per 32-day block, coefficients
#: per component) as DE440's IPT publishes them (the header record of
#: linux_p1550p2650.440); 10 is the Sun (zero here: the analytic source is
#: heliocentric), 301 the geocentric Moon
DE440_LAYOUT = {1: (4, 14), 2: (2, 10), 3: (2, 13), 4: (1, 11), 5: (1, 8), 6: (1, 7), 7: (1, 6), 8: (1, 6),
                9: (1, 6), 301: (8, 13), 10: (2, 11)}
#: the DE file slot of each body (Mercury .. Pluto barycentres, Moon, Sun)
DE_SLOT = {1: 0, 2: 1, 3: 2, 4: 3, 5: 4, 6: 5, 7: 6, 8: 7, 9: 8, 301: 9, 10: 10}
#: phase 14: the most the DE440-layout fits' converged counts may differ from
#: phase 4's, as a share of the trajectories
DE440_CONVERGED_SHARE = 1e-3
#: phase 14: the debiasing table's resolution (the published one's, the
#: loader's default)
DEBIAS_NSIDE = 64
#: phase 14: how far the mixed-precision fit of the debiased observations may
#: lie from the mixed fit of the same data debiased on the host, in the
#: latter's 1-sigma uncertainties, with the same active observations.  With
#: float32 Jacobians the 8467 copies' correction norm does not settle under
#: the 1e-4 convergence threshold: it bounces between about 1e-4 and 3e-3
#: until one step dips under the threshold or the RMS stagnates, so two
#: starts a float32 rounding apart stop at two points of that floor
#: (tools/torch_lsq/mixed_spread.py; PERF.md §6)
MIXED_DEBIAS_SIGMA = 1e-2


def de440_layout_tables():
    """The analytic source refitted over DE440's span at DE440's granules
    and coefficient counts (:data:`DE440_LAYOUT`), the Sun a zero table."""
    import torch

    from outfit_tpu_torch.ephem import analytic
    from outfit_tpu_torch.ephem.bodies import Body
    from outfit_tpu_torch.ephem.chebyshev import BodyTable, fit_body_table

    t0, t1 = DE440_SPAN
    tables = {}
    for b, (ns, c) in DE440_LAYOUT.items():
        gran = DE440_BLOCK_DAYS / ns
        if b == 10:
            n = int(round((t1 - t0) / gran))
            tables[Body.SUN] = BodyTable(t0, gran, torch.zeros(n, 3, c, dtype=torch.float64))
            continue
        if b == 301:
            fn = lambda m: analytic._ecl_to_equ(analytic.moon_geocentric_ecliptic(m))  # noqa: E731
        else:
            fn = lambda m, b=b: analytic._ecl_to_equ(analytic.planet_position_ecliptic(Body(b), m))  # noqa: E731
        tables[Body(b)] = fit_body_table(fn, t0, t1, gran, c)
    return tables


def write_de_files(tables, directory, emrat, au_km=None, naif=True):
    """Write ``tables`` (heliocentric planets and EMB, geocentric Moon, a
    zero Sun, one start epoch and 32-day blocks) as a legacy DE binary (all
    slots, ``au_km`` if given) and, with ``naif``, as an SPK kernel in
    DE440's layout: the nine barycentres and the Sun relative to the solar
    system barycentre, the Moon (301) and the Earth (399) relative to the
    EMB.  Returns ``(naif path or None, horizon path)``."""
    from outfit_tpu_torch.ephem.bodies import Body
    from outfit_tpu_torch.ephem.chebyshev import BodyTable
    from outfit_tpu_torch.ephem.horizon import write_synthetic_horizon
    from outfit_tpu_torch.ephem.naif import write_synthetic_spk

    kw = {} if au_km is None else {"au_km": au_km}
    hpath = os.path.join(directory, "de.bin")
    specs = {DE_SLOT[int(b)]: (tb, int(round(DE440_BLOCK_DAYS / tb.granule_days))) for b, tb in tables.items()}
    write_synthetic_horizon(hpath, specs, emrat=emrat, **kw)
    if not naif:
        return None, hpath
    npath = os.path.join(directory, "de.bsp")
    f = 1.0 / (1.0 + emrat)
    moon = tables[Body.MOON]
    segs = [(int(b), 0, tables[b]) for b in tables if b != Body.MOON]
    segs += [(301, 3, BodyTable(moon.t0, moon.granule_days, moon.coeffs * (1.0 - f))),
             (399, 3, BodyTable(moon.t0, moon.granule_days, moon.coeffs * -f))]
    write_synthetic_spk(npath, segs)
    return npath, hpath


def _utc_parts(mjd_tt, per_day):
    """(calendar dates 'YYYY-MM-DD', time of day in units of 1/per_day) of
    the UTC epochs of ``mjd_tt``, rounded to that unit."""
    import numpy as np

    from outfit_tpu_torch.time.scales import tt_mjd_to_utc

    q = np.rint(tt_mjd_to_utc(mjd_tt) * per_day).astype(np.int64)
    days, part = np.divmod(q, per_day)
    return (np.datetime64("1858-11-17") + days.astype("timedelta64[D]")).astype(str), part


def write_mpc80(path, ds):
    """The dataset as MPC 80-column records: its trajectory ids as
    provisional designations, epochs to 1e-6 d (UTC), RA to 0.001 s, Dec to
    0.01 arcsec, magnitude, catalog code (column 72) and station."""
    import numpy as np

    dates, frac = _utc_parts(ds.mjd_tt, 10**6)
    ra_ms = np.rint(ds.ra * (12.0 / np.pi) * 3.6e6).astype(np.int64) % (24 * 3600 * 1000)
    dec_cas = np.rint(np.abs(ds.dec) * (180.0 / np.pi) * 3.6e5).astype(np.int64)
    codes = [o.code for o in ds.observers]
    lines = []
    for i in range(len(ds)):
        y, mo, d = dates[i].split("-")
        h, r = divmod(int(ra_ms[i]), 3600000)
        m, r = divmod(r, 60000)
        ra = f"{h:02d} {m:02d} {r // 1000:02d}.{r % 1000:03d}"
        dd, r2 = divmod(int(dec_cas[i]), 360000)
        dm, r2 = divmod(r2, 6000)
        dec = f"{'-' if ds.dec[i] < 0 else '+'}{dd:02d} {dm:02d} {r2 // 100:02d}.{r2 % 100:02d}"
        mag = "     " if np.isnan(ds.mag[i]) else f"{ds.mag[i]:5.2f}"
        lines.append(f"     {ds.traj_ids[ds.traj_index[i]]:<7}  C{y} {mo} {d}.{frac[i]:06d}{ra}{dec}         "
                     f"{mag} {ds.catalog[i]}     {codes[ds.observer_index[i]]}\n")
    with open(path, "w", encoding="ascii") as fh:
        fh.writelines(lines)


def write_ades(path, ds):
    """The dataset as an ADES XML file: provID, stn, obsTime (UTC to 1 us),
    ra and dec (degrees), rmsRA and rmsDec (arcsec) from its sigmas."""
    import numpy as np

    dates, us = _utc_parts(ds.mjd_tt, 86400 * 10**6)
    codes = [o.code for o in ds.observers]
    ra, dec = np.degrees(ds.ra), np.degrees(ds.dec)
    rms_ra, rms_dec = ds.ra_error / (np.pi / 648000.0), ds.dec_error / (np.pi / 648000.0)
    out = ['<?xml version="1.0" encoding="UTF-8"?>\n<ades version="2022">\n<obsBlock>\n<obsData>\n']
    for i in range(len(ds)):
        s, u = divmod(int(us[i]), 10**6)
        h, s = divmod(s, 3600)
        m, s = divmod(s, 60)
        out.append(f"<optical><provID>{ds.traj_ids[ds.traj_index[i]]}</provID><stn>{codes[ds.observer_index[i]]}"
                   f"</stn><obsTime>{dates[i]}T{h:02d}:{m:02d}:{s:02d}.{u:06d}Z</obsTime><ra>{ra[i]:.9f}</ra>"
                   f"<dec>{dec[i]:.9f}</dec><rmsRA>{rms_ra[i]:.6f}</rmsRA><rmsDec>{rms_dec[i]:.6f}</rmsDec>"
                   f"</optical>\n")
    out.append("</obsData>\n</obsBlock>\n</ades>\n")
    with open(path, "w", encoding="utf-8") as fh:
        fh.writelines(out)


def write_debias_table(path, catalogs, seed=14):
    """A table in the published bias.dat format at NSIDE 64 for
    ``catalogs``: offsets drawn from ``default_rng(seed)``, U(-0.5, 0.5)
    arcsec, proper-motion terms U(-5, 5) mas/yr."""
    import numpy as np

    rng = np.random.default_rng(seed)
    npix = 12 * DEBIAS_NSIDE * DEBIAS_NSIDE
    vals = np.empty((npix, len(catalogs), 4))
    vals[..., :2] = rng.uniform(-0.5, 0.5, (npix, len(catalogs), 2))
    vals[..., 2:] = rng.uniform(-5.0, 5.0, (npix, len(catalogs), 2))
    with open(path, "w", encoding="ascii") as fh:
        fh.write(f"! Star catalog debiasing table, HEALPix NSIDE= {DEBIAS_NSIDE} RING scheme\n")
        fh.write("! " + " ".join(catalogs) + "\n")
        np.savetxt(fh, vals.reshape(npix, -1), fmt="%.6f")


def _fitted(tag, dev, eph, ds, seeds, cfg, total, body_launches):
    """One seeded fit on the card, its wall and fits/s, with the kernel's
    launches (counted from 0 for this fit, added to ``total``) held to one
    observer cache build: ``body_launches`` at the body site (2 for the
    analytic source, 3 for a DE file: EMB, Moon or Earth, and Sun) and 1
    at the frame site."""
    from outfit_tpu_torch import fit_lsq
    from outfit_tpu_torch.ephem import chebyshev_cuda

    chebyshev_cuda.reset_launch_counts()
    res, wall = _timed(lambda: fit_lsq(ds, eph, config=cfg, initial_orbits=seeds, device=dev), dev)
    got = _tally(total)
    if got != {"body": body_launches, "frame": 1}:
        raise AssertionError(f"{tag}: one cache build should launch the kernel {body_launches} times at the body "
                             f"site and once at the frame site, got {got}")
    _check_results(res, ds)
    conv = sum(r.status == 1 and not r.fell_back_to_iod for r in res.values())
    _log(f"  {tag}: {conv}/{len(res)} converged, wall {wall!r} s, {len(res) / wall!r} fits/s, launches {got}")
    return res, conv


def _deviation(a, b, rows):
    """Largest element deviation between two result dicts over ``rows``."""
    import numpy as np

    return max((float(np.abs(a[t].equinoctial - b[t].equinoctial).max()) for t in rows), default=0.0)


def _hold(got, ref, rtol, atol):
    """``got`` against ``ref`` at (rtol, atol) on the rows converged in both.
    Returns (largest deviation, rows compared, the rows off the bar, the
    largest deviation of those in the reference's 1-sigma uncertainties,
    the rows whose count of active observations differs)."""
    import numpy as np

    rows = [t for t in ref if ref[t].status == 1 and got[t].status == 1
            and not ref[t].fell_back_to_iod and not got[t].fell_back_to_iod]
    off, sigma, selection = [], 0.0, []
    for t in rows:
        a, b = got[t], ref[t]
        d = np.abs(a.equinoctial - b.equinoctial)
        if not np.all(d <= atol + rtol * np.abs(b.equinoctial)):
            off.append(t)
            sigma = max(sigma, float((d / b.uncertainties).max()))
        if a.n_active_obs != b.n_active_obs:
            selection.append(t)
    return _deviation(got, ref, rows), len(rows), off, sigma, selection


def phase_files(dev, eph, ds, picks, res4, walls4, synth):
    """Phase 14: from files to orbits."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from outfit_tpu_torch import DifferentialCorrectionConfig, JPLEphem, ObsDataset, fit_lsq
    from outfit_tpu_torch.ephem.bodies import Body
    from outfit_tpu_torch.ephem.chebyshev import BodyTable, interpolate_body, interpolate_body_plain
    from outfit_tpu_torch.observations.debias import DebiasTable, ang2pix_ring
    from outfit_tpu_torch.observations.native import native_available

    torch.cuda.reset_peak_memory_stats()
    total = {"body": 0, "frame": 0}
    seeds = seeds_for(ds, picks)
    cfg = DifferentialCorrectionConfig()
    n = len(ds.traj_ids)
    tmp = tempfile.mkdtemp(prefix="outfit_phase14_")
    clock = [time.perf_counter()]

    def step_done(label):
        now = time.perf_counter()
        _log(f"  ({label}: {now - clock[0]!r} s)")
        clock[0] = now

    try:
        # 1. DE440-layout files
        t = time.perf_counter()
        tables = de440_layout_tables()
        refit = time.perf_counter() - t
        t = time.perf_counter()
        npath, hpath = write_de_files(tables, tmp, eph.emrat)
        _log(f"DE440 layout: refit {refit!r} s ({sum(tb.coeffs.numel() for tb in tables.values()) * 8 / 1e6:.1f} MB "
             f"of coefficients), written {time.perf_counter() - t!r} s: SPK {os.path.getsize(npath) / 1e6:.1f} MB, "
             f"DE binary {os.path.getsize(hpath) / 1e6:.1f} MB")
        files = {}
        for name, src, path in (("NAIF", "naif:DE440", npath), ("Horizon", "horizon:DE440", hpath)):
            t = time.perf_counter()
            e = JPLEphem(src, path=path)
            parse = time.perf_counter() - t
            e_d, up = _timed(lambda: e.to(dev), dev)
            nbytes = sum(tb.coeffs.numel() * 8 for tb in e_d.tables.values())
            _log(f"  {name}: parsed in {parse!r} s, uploaded in {up!r} s; {len(e.tables)} tables, {nbytes} bytes "
                 f"on the card; coverage {e.coverage}")
            files[name] = e

        step_done("DE440-layout files")

        # 2. K1 on every parsed table at the paths' query counts
        queries = dict(planet_queries(synth))
        queries[len(padded_queries(ds.mjd_tt))] = padded_queries(ds.mjd_tt)
        worst = 0.0
        for name, e in files.items():
            e_d = e.to(dev)
            for body, table in e_d.tables.items():
                g, _, c = table.coeffs.shape
                for nq, q in sorted(queries.items()):
                    mjd = torch.as_tensor(q, dtype=torch.float64, device=dev)
                    (p, v), (p0, v0) = interpolate_body(table, mjd), interpolate_body_plain(table, mjd)
                    scale = max(1.0, torch.sqrt(torch.sum(p0 * p0, -1)).max().item())
                    dp, dv = (p - p0).abs().max().item(), (v - v0).abs().max().item()
                    if not (dp <= POS_ATOL * scale and dv <= VEL_ATOL * scale):
                        raise AssertionError(f"K1 {name} {Body(body).name} C={c} G={g} N={nq}: deviates from its plain "
                                             f"version by {dp!r} AU, {dv!r} AU/day at scale {scale!r}")
                    worst = max(worst, dp)
                    ms = device_ms(lambda: interpolate_body(table, mjd))
                    bound, by = k1_bound_ms(nq, (g, 3, c), True, touched_rows(q, table.t0, table.granule_days, g))
                    plain_ms = _median_ms(lambda: interpolate_body_plain(table, mjd), runs=5)
                    _log(f"K1 body {name} {Body(body).name} C={c} G={g} N={nq}: device {1e3 * ms!r} us, bound "
                         f"{1e3 * bound!r} us ({by}), share {bound / ms!r}, plain version {plain_ms!r} ms; max|d| "
                         f"{dp!r} AU, {dv!r} AU/day (largest distance {scale!r} AU)")

        step_done("K1 on the parsed tables")

        # 3. phase 4's tables through a Horizon file, bitwise
        zero = BodyTable(eph.tables[Body.EMB].t0, eph.tables[Body.EMB].granule_days,
                         torch.zeros_like(eph.tables[Body.EMB].coeffs))
        sub = os.path.join(tmp, "span")
        os.makedirs(sub)
        _, rpath = write_de_files({**eph.tables, Body.SUN: zero}, sub, eph.emrat, au_km=2.0**27, naif=False)
        e_rt = JPLEphem("horizon:DE440", path=rpath)
        for b, tb in eph.tables.items():
            if not torch.equal(e_rt.tables[b].coeffs, tb.coeffs) or e_rt.tables[b][:2] != tb[:2]:
                raise AssertionError(f"{Body(b).name}: the Horizon round trip changed the table")
        res_rt, _ = _fitted("phase 4 through a Horizon file (cold)", dev, e_rt, ds, seeds, cfg, total, 3)
        for tid in ds.traj_ids:
            a, b = res_rt[tid], res4[tid]
            same = (a.status, a.fell_back_to_iod, a.normalised_rms) == (b.status, b.fell_back_to_iod, b.normalised_rms)
            same = same and np.array_equal(a.equinoctial, b.equinoctial)
            if not (same and (b.covariance is None or np.array_equal(a.covariance, b.covariance))):
                raise AssertionError(f"{tid}: the fit from the Horizon file differs from phase 4's")
        _log(f"  every row bitwise phase 4's (phase 4: {n / walls4[0]!r} fits/s cold, {n / walls4[1]!r} warm)")

        step_done("bitwise round trip")

        # 4. DE440-layout fits
        conv4 = sum(r.status == 1 and not r.fell_back_to_iod for r in res4.values())
        fits = {}
        for name, e in files.items():
            fits[name], conv = _fitted(f"DE440 layout, {name}", dev, e, ds, seeds, cfg, total, 3)
            dev4 = _deviation(fits[name], res4, [t for t in ds.traj_ids if fits[name][t].status == res4[t].status == 1])
            _log(f"    against phase 4 (analytic, {conv4} converged): largest element deviation {dev4!r}")
            if abs(conv - conv4) > DE440_CONVERGED_SHARE * n:
                raise AssertionError(f"{name}: {conv} converged against phase 4's {conv4}")
        worst_nh, rows, off, _, _ = _hold(fits["NAIF"], fits["Horizon"], 1e-6, 1e-9)
        _log(f"  NAIF vs Horizon on {rows} rows converged in both: {worst_nh!r}")
        if off:
            raise AssertionError(f"NAIF and Horizon fits differ beyond rtol 1e-6 / atol 1e-9 on {off}")
        eph_n = files["NAIF"]
        rg = fit_lsq(head(ds, N_CHECK), eph_n, config=cfg, initial_orbits=seeds, device=dev)
        rc = fit_lsq(head(ds, N_CHECK), eph_n, config=cfg, initial_orbits=seeds, device="cpu")
        for tid in rg:
            a, b = rc[tid], rg[tid]
            if (a.status, a.fell_back_to_iod, a.n_active_obs) != (b.status, b.fell_back_to_iod, b.n_active_obs):
                raise AssertionError(f"{tid}: card and CPU disagree on the NAIF file")
            np.testing.assert_allclose(b.equinoctial, a.equinoctial, rtol=1e-6, atol=1e-9, err_msg=tid)
        _log(f"  NAIF card vs CPU, {N_CHECK} trajectories: same statuses; max |d elements| "
             f"{_deviation(rg, rc, list(rg))!r}")

        step_done("DE440-layout fits")

        # 5. observation files
        mpath, apath = os.path.join(tmp, "obs.txt"), os.path.join(tmp, "obs.xml")
        write_mpc80(mpath, ds)
        write_ades(apath, ds)
        if not native_available():
            raise AssertionError("the native MPC parser did not build (no cc?): the smoke would time the Python one")
        parsed = {}
        for tag, fn in (("MPC native", lambda: ObsDataset.from_mpc_80_col_files([mpath], True, False)),
                        ("MPC Python", lambda: ObsDataset.from_mpc_80_col_files([mpath], False, False)),
                        ("ADES", lambda: ObsDataset.from_ades(apath))):
            t = time.perf_counter()
            parsed[tag] = fn()
            sec = time.perf_counter() - t
            _log(f"  {tag}: {len(parsed[tag])} records in {sec!r} s, {len(parsed[tag]) / sec!r} records/s")
            if parsed[tag].traj_ids != ds.traj_ids or len(parsed[tag]) != len(ds):
                raise AssertionError(f"{tag}: parsed {len(parsed[tag])} records of {len(parsed[tag].traj_ids)} "
                                     f"trajectories, wrote {len(ds)} of {n}")
        a, b = parsed["MPC native"], parsed["MPC Python"]
        for f in ("traj_index", "observer_index", "catalog"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"native and Python MPC parsers differ in {f}")
        if [vars(o) for o in a.observers] != [vars(o) for o in b.observers]:
            raise AssertionError("native and Python MPC parsers differ in the observers")
        d = {f: float(np.abs(getattr(a, f) - getattr(b, f)).max()) for f in ("mjd_tt", "ra", "dec")}
        if not (d["mjd_tt"] <= 1e-9 and d["ra"] <= 1e-12 and d["dec"] <= 1e-12):
            raise AssertionError(f"native and Python MPC parsers differ: {d}")
        _log(f"  native vs Python MPC datasets: indices, catalogs and observers identical; max |d| {d}")
        for tag, pds in parsed.items():
            _fitted(f"{tag} file, NAIF DE440 layout", dev, eph_n, pds, seeds, cfg, total, 3)

        step_done("observation files")

        # 6. debiasing
        cats = sorted(set(ds.catalog) - {" "})
        tpath = os.path.join(tmp, "bias.dat")
        write_debias_table(tpath, cats)
        t = time.perf_counter()
        table = DebiasTable.load(tpath)
        _log(f"  debiasing table NSIDE {table.nside}, catalogs {table.catalogs}: loaded in {time.perf_counter() - t!r} s")
        b_ra, b_dec = table.bias_radians(ds.ra, ds.dec, ds.mjd_tt, ds.catalog)
        shifted = dataclasses.replace(ds, ra=ds.ra + b_ra, dec=ds.dec + b_dec)
        raw = dataclasses.replace(shifted)
        shifted.apply_debias(table)
        crossed = int((ang2pix_ring(table.nside, ds.ra, ds.dec) != ang2pix_ring(table.nside, shifted.ra,
                                                                                 shifted.dec)).sum())
        clean = dataclasses.replace(ds, ra=shifted.ra - shifted.bias_ra, dec=shifted.dec - shifted.bias_dec)
        _log(f"  shift: max {np.abs(b_ra).max() / (np.pi / 648000.0)!r} arcsec in RA; {int((b_ra != 0).sum())} of "
             f"{len(ds)} observations biased; {crossed} moved into another sky pixel (so the clean reference is "
             f"the data debiased on the host)")
        clean_fits = {}
        for prec in ("f64", "mixed"):
            pcfg = DifferentialCorrectionConfig(precision=prec)
            clean_fits[prec], _ = _fitted(f"clean (debiased on the host), {prec}", dev, eph_n, clean, seeds, pcfg,
                                          total, 3)
            got, _ = _fitted(f"debiased, {prec}", dev, eph_n, shifted, seeds, pcfg, total, 3)
            w, rows, off, sigma, selection = _hold(got, clean_fits[prec], 1e-7, 1e-9)
            _log(f"    against the clean fit in {prec} on {rows} rows converged in both: {w!r}; {len(off)} rows off "
                 f"rtol 1e-7 / atol 1e-9, at most {sigma!r} sigma; {len(selection)} with other active observations")
            # float64 subtracts the bias as the host did: the same numbers; the
            # mixed pre-warm rounds observation and bias to float32 apart, so
            # it starts elsewhere and stops elsewhere inside the convergence
            # threshold (MIXED_DEBIAS_SIGMA)
            if (prec == "f64" and off) or selection or sigma > MIXED_DEBIAS_SIGMA:
                raise AssertionError(f"debiased {prec} fit off the clean fit: {len(off)} rows off the bar, up to "
                                     f"{sigma!r} sigma, {len(selection)} with other active observations")
        ref = clean_fits["f64"]
        w, rows, off, _, _ = _hold(ref, fits["NAIF"], 1e-7, 1e-9)
        if off:
            raise AssertionError(f"the host-debiased data fits off the unshifted data's fit on {off}")
        w_mx, rows_mx, off_mx, sigma_mx, sel_mx = _hold(clean_fits["mixed"], ref, 1e-7, 1e-9)
        _log(f"    clean float64 fit against the unshifted data's on {rows} rows: {w!r}; clean mixed against clean "
             f"float64 on {rows_mx} rows: {w_mx!r}, {len(off_mx)} rows off the bar, at most {sigma_mx!r} sigma, "
             f"{len(sel_mx)} with other active observations")
        nobias, _ = _fitted("shifted, no bias", dev, eph_n, raw, seeds, cfg, total, 3)
        moved = _deviation(nobias, ref, [t for t in ds.traj_ids if nobias[t].status == ref[t].status == 1])
        _log(f"    the orbit moves by up to {moved!r} without the bias")
        if not moved > 1e-6:
            raise AssertionError(f"fitting the shifted data without its bias moved the orbits by only {moved!r}")
        step_done("debiasing")
        _log(f"phase 14: kernel launches {total}; peak memory {_peak_gb():.3f} GiB")
        return total, worst
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _identical(a, b):
    """Two result rows (``LsqResult`` or ``FitResult``) equal on every field,
    bitwise (NaN equal to NaN), the IOD rows too."""
    import numpy as np

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "iod" and x is not None and y is not None:
            if not _identical(x, y):
                return False
        elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if x is None or y is None or x.dtype != y.dtype or not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
                return False
        elif not (x == y or (x != x and y != y)):
            return False
    return True


def _identical_tables(a, b):
    """Two ``LsqTable``s equal in every field their equality compares (not
    the lazily built row index), bitwise (NaN equal to NaN)."""
    import numpy as np

    for f in dataclasses.fields(a):
        if not f.compare:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if x is None or y is None or x.dtype != y.dtype or not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
                return False
        elif x != y:
            return False
    return True


def _hold_rows(tag, ref, got):
    if list(got) != list(ref):
        raise AssertionError(f"{tag}: rows or their order differ from one device's")
    for tid, r in ref.items():
        if not _identical(r, got[tid]):
            raise AssertionError(f"{tid}: {tag} differs from one device's fit")


def phase_split(dev, eph, ref):
    """Phase 15: the fits of phases 4, 6, 8, 9 and 10 over a device list
    (the card named two and three times, ``"auto"`` and None), each bitwise
    its single-device result with one observer cache build per fit; the warm
    walls of one device and of the two-way split in turns."""
    import torch

    from outfit_tpu_torch import LsqTable, fit_lsq, fit_lsq_escalating, fit_lsq_stream
    from outfit_tpu_torch.ephem import chebyshev_cuda
    from outfit_tpu_torch.lsq import fit_lsq_dispatch, fit_lsq_finalize
    from outfit_tpu_torch.parallel.sharding import chunk_bounds

    card = torch.device("cuda", torch.cuda.current_device()) if torch.device(dev).type == "cuda" else dev
    two, three = [card] * 2, [card] * 3
    launches = {"body": 0, "frame": 0}

    def fit_counted(tag, fits, fn):
        chebyshev_cuda.reset_launch_counts()
        t = time.perf_counter()
        out = fn()
        _sync(dev)
        wall = time.perf_counter() - t
        got = dict(chebyshev_cuda.launches)
        _per_fit(tag, got, fits)
        for site in launches:
            launches[site] += got[site]
        return out, wall

    ds, seeds, res4 = ref["ds4"], ref["seeds4"], ref["res4"]
    n = len(ds.traj_ids)
    _log(f"  chunks of phase 4's {n} rows: two ways {chunk_bounds([(0, n)], 2)}, three ways "
         f"{chunk_bounds([(0, n)], 3)}")
    for devices in (two, three, "auto", None):
        tag = f"phase 4 on device={devices!r}"
        got, wall = fit_counted(tag, 1, lambda: fit_lsq(ds, eph, initial_orbits=seeds, device=devices))
        _hold_rows(tag, res4, got)
        _log(f"  {tag}: every row bitwise phase 4's, 2 + 1 K1 launches; {wall!r} s")
    walls = {"one": [], "two": []}
    for which in ("one", "two", "two", "one"):
        _, wall = fit_counted(f"phase 4 timing ({which})", 1,
                          lambda: fit_lsq(ds, eph, initial_orbits=seeds, device=dev if which == "one" else two))
        walls[which].append(wall)
    _log(f"  phase 4 warm walls in turns (one device, split, split, one device): "
         f"one {walls['one']!r} s ({[n / w for w in walls['one']]!r} fits/s), "
         f"two-way split {walls['two']!r} s ({[n / w for w in walls['two']]!r} fits/s)")

    synth = ref["synth"]
    got, wall = fit_counted("phase 8 split two ways", 1,
                        lambda: fit_lsq(synth, eph, ref["headline"], ref["headline_cfg"], 7, device=two))
    _hold_rows("phase 8 split two ways", ref["res8"], got)
    _log(f"  phase 8 (mixed) split two ways: every row bitwise phase 8's, total_newton_iterations included; "
         f"{wall!r} s")

    datasets, tables = ref["data9"], ref["tables9"]
    out, wall = fit_counted("phase 9 split two ways", len(datasets), lambda: list(fit_lsq_stream(
        datasets, eph, ref["headline"], ref["headline_cfg"], 7, slim_fetch=True, as_table=True, minimal_fetch=True,
        device=two)))
    for k, ((d, table), ref_table) in enumerate(zip(out, tables)):
        if d is not datasets[k] or not _identical_tables(ref_table, table):
            raise AssertionError(f"phase 9 split two ways: dataset {k}'s table differs from phase 9's")
    _log(f"  phase 9 stream (slim, table, minimal) split two ways: the {len(tables)} tables bitwise phase 9's; "
         f"{wall!r} s")

    ds10, esc10, fits10 = ref["ds10"], ref["esc10"], ref["fits10"]
    got, wall = fit_counted("phase 10 escalating split two ways", fits10,
                        lambda: fit_lsq_escalating(ds10, eph, ref["stages10"], 7, device=two))
    _hold_rows("phase 10 escalating split two ways", esc10, got)
    _log(f"  phase 10 fit_lsq_escalating split two ways: every row bitwise phase 10's; {wall!r} s")

    lean, cfg = ref["lean"], ref["cfg"]
    got, wall = fit_counted("phase 6 dispatch / finalize", 1,
                        lambda: fit_lsq_finalize(fit_lsq_dispatch(synth, eph, lean, cfg, 7, device=dev)))
    _hold_rows("fit_lsq_finalize(fit_lsq_dispatch(...))", ref["res6"], got)
    pending, wall_t = fit_counted("phase 6 dispatch / finalize, table", 1,
                              lambda: fit_lsq_dispatch(synth, eph, lean, cfg, 7, as_table=True, device=dev))
    table = fit_lsq_finalize(pending)
    if table is not fit_lsq_finalize(pending) or not _identical_tables(
            LsqTable.from_results(synth.traj_ids, ref["res6"]), table):
        raise AssertionError("fit_lsq_finalize(fit_lsq_dispatch(..., as_table=True)) differs from phase 6's table")
    _log(f"  phase 6 through fit_lsq_dispatch / fit_lsq_finalize: bitwise phase 6's as a dict ({wall!r} s) and as "
         f"a table ({wall_t!r} s)")
    return launches


def fg_phase(tag, total, fn, *args):
    """``fn(*args)`` with the f-g correction kernel's launch counts reset
    and the IOD's chunks on a card counted (``iod/api.py:_iod_kernel`` runs
    once a chunk): the launches must be two a mixed chunk (the float32
    candidate pass and the float64 polish) and one a float64 chunk.  Adds
    them to ``total`` and returns what ``fn`` returns."""
    import threading

    from outfit_tpu_torch.iod import api, fg_correction_cuda

    want = {"float32": 0, "float64": 0}
    lock = threading.Lock()
    kernel = api._iod_kernel

    def chunk(tri, obs_arrays, lane_traj, window_mask, params):
        if tri.time.is_cuda and tri.time.shape[0]:
            with lock:
                want["float32"] += params.precision == "mixed"
                want["float64"] += 1
        return kernel(tri, obs_arrays, lane_traj, window_mask, params)

    fg_correction_cuda.reset_launch_counts()
    api._iod_kernel = chunk
    try:
        out = fn(*args)
    finally:
        api._iod_kernel = kernel
    got = dict(fg_correction_cuda.launches)
    if got != want:
        raise AssertionError(f"{tag}: f-g kernel launches {got}, want {want} (2 a mixed chunk, 1 a float64 chunk)")
    _log(f"{tag}: f-g kernel launches {got}")
    for work in total:
        total[work] += got[work]
    return out


def fg_kernels(times, launches):
    """The ``kernels`` line's entries of the f-g correction kernel, one per
    working type: ``launches`` summed over the main path's phases
    (:func:`fg_phase`) and phase 3c's times."""
    return [
        {
            "name": f"fg_correction_{work}",
            "route": "cuda",
            "source": FG_KERNEL_SRC,
            "replaces": FG_REPLACES,
            "launches": launches[work],
            "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            # no PyTorch call runs a per-candidate iteration to its own exit
            "library_ms": None,
        }
        for work, t in sorted(times.items())
    ]


def step_phase(tag, total, fn, *args):
    """``fn(*args)`` with the two-body step kernel's launch counts reset and
    the correction's Newton steps counted (``lsq/loop.py`` calls
    ``single_iteration`` once a step): the launches of each working type
    must equal the two-body steps of that type on a card, and
    ``trace.lsq_step.two_body`` must have counted every two-body step, on
    the card and on the CPU; an N-body step is neither.  Adds the launches
    to ``total`` and returns what ``fn`` returns."""
    import threading

    from outfit_tpu_torch import trace
    from outfit_tpu_torch.lsq import loop, step_cuda

    want = dict.fromkeys(step_cuda.launches, 0)
    steps = [0]
    lock = threading.Lock()
    si = loop.single_iteration

    def step(*a, **k):
        prop = a[5] if len(a) > 5 else k.get("propagator")
        if prop is None or not prop.nbody:
            with lock:
                steps[0] += 1
                if a[3].mjd.is_cuda:
                    want[step_kind((a, k))] += 1
        return si(*a, **k)

    step_cuda.reset_launch_counts()
    before = trace.lsq_step.two_body
    loop.single_iteration = step
    try:
        out = fn(*args)
    finally:
        loop.single_iteration = si
    got, counted = dict(step_cuda.launches), trace.lsq_step.two_body - before
    if got != want or counted != steps[0]:
        raise AssertionError(f"{tag}: step kernel launches {got}, want {want} (one a two-body step on a card); "
                             f"trace.lsq_step.two_body counted {counted} of {steps[0]} two-body steps")
    _log(f"{tag}: step kernel launches {got}; two-body steps {steps[0]}, {steps[0] - sum(want.values())} on the CPU")
    for work in total:
        total[work] += got[work]
    return out


def step_kernels(times, launches):
    """The ``kernels`` line's entries of the two-body step kernel, one per
    working type: ``launches`` summed over the main path's phases
    (:func:`step_phase`) and phase 3d's times at the type's largest shape."""
    return [
        {
            "name": f"lsq_step_{work}",
            "route": "cuda",
            "source": STEP_KERNEL_SRC,
            "replaces": STEP_REPLACES,
            "launches": launches[work],
            "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            # no PyTorch call runs a trajectory's Newton step, Kepler solves
            # to their own exits, in one launch
            "library_ms": None,
        }
        for work, t in sorted(times.items())
    ]


def main():
    sys.path.insert(0, HERE)
    dev = phase_device()
    import torch

    phase_build()
    from outfit_tpu_torch import JPLEphem

    eph = JPLEphem.analytic(*SPAN)
    ds, picks = real_cadence_dataset(N_TRAJ)
    synth = synthetic_dataset(N_SYNTH, N_SYNTH_OBS, eph)
    times = phase_kernel_check(dev, eph, {"real cadence": ds, "synthetic": synth})
    planets_err = phase_kernel_check_planets(dev, eph, synth)
    fg = phase_fg_kernel(dev, eph, synth)
    times["body"]["err"] = max(times["body"]["err"], planets_err)

    from outfit_tpu_torch import DifferentialCorrectionConfig, IODParams

    lean = IODParams(n_noise_realizations=3, newton_max_it=20, max_triplets=2)
    cfg = DifferentialCorrectionConfig(divergence_grace_iterations=2, max_newton_iterations=4)
    rich = IODParams(n_noise_realizations=0, newton_max_it=20, max_triplets=16, max_obs_for_triplets=48)
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
    step = phase_step_kernel(dev, eph, synth, ds, picks, (headline, headline_cfg))
    # the f-g and step kernels' launches of the main path, phases 4 to 15
    fg_launches = {"float32": 0, "float64": 0}
    step_launches = {"float32": 0, "float64_float32": 0, "float64": 0}

    def main_phase(tag, phase, *args):
        return fg_phase(tag, fg_launches, step_phase, tag, step_launches, phase, *args)

    launches, cold4, warm4, res4 = main_phase("seeded 4096", phase_slice, dev, eph, ds, picks)
    ref = dict(ds4=ds, seeds4=seeds_for(ds, picks), res4=res4, synth=synth)
    main_phase("card against CPU 64", phase_cross_check, dev, eph, ds, picks)

    def timed_phase(tag, phase, *args):
        t = time.perf_counter()
        out = main_phase(tag, phase, *args)
        _log(f"{tag} phase: {time.perf_counter() - t!r} s")
        return out

    def add(got):
        for site in launches:
            launches[site] += got[site]

    tag = "synthetic 8192 x 12 IOD+LSQ"
    got, warm6, summ6, res6 = timed_phase(tag, phase_unseeded, dev, eph, synth, lean, cfg, 7, tag)
    add(got)
    tag = "real-cadence 4096 IOD+LSQ"
    add(timed_phase(tag, phase_unseeded, dev, eph, ds, rich, DifferentialCorrectionConfig(), 7, tag)[0])
    got, res8 = timed_phase("mixed synthetic 8192 x 12 IOD+LSQ", phase_mixed, dev, eph, synth, headline, headline_cfg,
                            7, warm6, summ6)
    add(got)
    got, data9, tables9 = timed_phase("stream synthetic 3 x 8192 x 12", phase_stream, dev, eph, (400, 401, 402),
                                      headline, headline_cfg, 7)
    add(got)
    table9 = tables9[0]
    stages10 = [(rc_lean, rc_lean_cfg), (rc_rich, headline_cfg)]
    got, ds10, esc10, fits10 = timed_phase("escalating real-cadence 3 x 4096", phase_escalating, dev, eph,
                                           (101, 102, 103), stages10, 7)
    add(got)
    ref.update(res6=res6, lean=lean, cfg=cfg, res8=res8, headline=headline, headline_cfg=headline_cfg, data9=data9,
               tables9=tables9, ds10=ds10, esc10=esc10, fits10=fits10, stages10=stages10)
    add(timed_phase("N-body propagation 4096 x 30 d", phase_nbody, dev, eph))
    add(timed_phase("ephemeris generation 8192 x 64", phase_ephemeris, dev, eph, res6, table9))
    add(timed_phase("N-body correction synthetic 8192 x 12", phase_nbody_correction, dev, eph, synth, lean, res6, summ6))
    got, files_err = timed_phase("from files to orbits", phase_files, dev, eph, ds, picks, res4, (cold4, warm4), synth)
    add(got)
    times["body"]["err"] = max(times["body"]["err"], files_err)
    add(timed_phase("fits split over a device list", phase_split, dev, eph, ref))

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SRC,
            "replaces": REPLACES,
            "launches": launches[site],
            "max_abs_err": times[site]["err"],
            "ms": times[site]["ms"],
            "device_ms": times[site]["device_ms"],
            "plain_ms": times[site]["plain_ms"],
            "bound_ms": times[site]["bound_ms"],
            "bound_by": times[site]["bound_by"],
            # no single PyTorch call gathers table rows and contracts them
            # with a Chebyshev basis
            "library_ms": None,
        }
        for name, site in (("chebyshev_body", "body"), ("chebyshev_frame", "frame"))
    ]
    print(json.dumps({"kernels": kernels + fg_kernels(fg, fg_launches) + step_kernels(step, step_launches)}))
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
