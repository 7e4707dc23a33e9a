"""A fitting service over a stream of survey batches with the PyTorch port:
``fit_lsq_stream`` (or, with ``--escalate``, ``fit_lsq_stream_escalating``)
emitting per-trajectory orbits with success/error accounting.

The port's form of ``examples/run_stream_service.py``.  That example takes
its batches from the JAX bench; this one builds them itself from the port
(random bound orbits observed 12 times over 40 days from the geocenter,
with 2.4e-6 rad of noise, as the bench's synthetic workload), so it imports
only ``outfit_tpu_torch``.

Usage:
    python examples/torch_run_stream_service.py [--batches N] [--traj-per-batch N] [--seed N]
        [--escalate] [--device DEV[,DEV...]]

``--device`` takes one device or a comma-separated list (each batch's
trajectories split over them); default the card when one is present.
"""

import argparse
import os
import sys
import time
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

N_OBS, SIGMA = 12, 2.4e-6


def synthetic_batch(n_traj, eph, seed):
    """``n_traj`` trajectories of ``N_OBS`` geocentric observations over 40
    days of random bound orbits (a in [1.2, 3.5] AU, e < 0.35, i < 0.6 rad),
    observed with ``eph`` and noised at ``SIGMA`` rad."""
    import torch

    from outfit_tpu_torch import ObsDataset, Observer
    from outfit_tpu_torch.constants import ROT_ECLMJ2000_TO_EQUMJ2000
    from outfit_tpu_torch.elements.twobody import propagate_twobody
    from outfit_tpu_torch.elements.types import EquinoctialElements, KeplerianElements, keplerian_to_equinoctial
    from outfit_tpu_torch.iod.scoring import apparent_radec
    from outfit_tpu_torch.utils.linalg import rotate3

    rng = np.random.default_rng(seed)
    T = n_traj
    kep = KeplerianElements(*(torch.as_tensor(x, dtype=torch.float64) for x in (
        np.full(T, 57000.0), rng.uniform(1.2, 3.5, T), rng.uniform(0.0, 0.35, T), rng.uniform(0.0, 0.6, T),
        rng.uniform(0, 2 * np.pi, T), rng.uniform(0, 2 * np.pi, T), rng.uniform(0, 2 * np.pi, T),
    )))
    mjd = 57000.0 + np.sort(rng.uniform(0, 40, (T, N_OBS)), axis=1)
    eq = keplerian_to_equinoctial(kep)
    st = propagate_twobody(EquinoctialElements(*(f[:, None] for f in eq)), 57000.0, torch.as_tensor(mjd),
                           compute_derivatives=False)
    helio, _ = eph.earth_ephemeris(torch.as_tensor(mjd.ravel()))
    ra, dec = apparent_radec(rotate3(ROT_ECLMJ2000_TO_EQUMJ2000, st.position),
                             rotate3(ROT_ECLMJ2000_TO_EQUMJ2000, st.velocity), helio.reshape(T, N_OBS, 3))
    ds = ObsDataset()
    ds.mjd_tt = mjd.ravel()
    ds.ra = (ra.numpy() + rng.normal(0, SIGMA, (T, N_OBS))).ravel()
    ds.dec = (dec.numpy() + rng.normal(0, SIGMA, (T, N_OBS))).ravel()
    ds.ra_error = np.full(T * N_OBS, SIGMA)
    ds.dec_error = np.full(T * N_OBS, SIGMA)
    ds.traj_index = np.repeat(np.arange(T, dtype=np.int64), N_OBS)
    ds.observer_index = np.zeros(T * N_OBS, np.int64)
    ds.traj_ids = [f"S{seed}_{i:06d}" for i in range(T)]
    ds.observers = [Observer.geocenter()]
    ds.mag = np.full(T * N_OBS, np.nan)
    ds.catalog = np.full(T * N_OBS, " ", dtype="U1")
    return ds


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--traj-per-batch", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=42)
    # tiered service mode: a lean IOD profile streams every batch and the
    # failures are refitted with a rich profile in batched passes
    ap.add_argument("--escalate", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = args.device if args.device is None or "," not in args.device else args.device.split(",")

    from outfit_tpu_torch import (
        DifferentialCorrectionConfig, IODParams, JPLEphem, fit_lsq_stream, fit_lsq_stream_escalating,
    )

    eph = JPLEphem.analytic(53500.0, 61500.0)
    iod_params = IODParams(n_noise_realizations=3, precision="mixed", max_triplets=2)
    cfg = DifferentialCorrectionConfig(precision="mixed", divergence_grace_iterations=2, max_newton_iterations=4,
                                       prewarm_max_iterations=16)

    def batches():
        for i in range(args.batches):
            yield synthetic_batch(args.traj_per_batch, eph, seed=1000 + i)

    outcomes = Counter()
    quality = []
    n_done = 0
    t0 = time.time()
    if args.escalate:
        rich = IODParams(n_noise_realizations=7, precision="mixed", max_triplets=8)
        stream = fit_lsq_stream_escalating(batches(), eph, [(iod_params, cfg), (rich, cfg)], seed=args.seed,
                                           as_table=False, device=device)
    else:
        stream = fit_lsq_stream(batches(), eph, iod_params, cfg, seed=args.seed, device=device)
    for i, (ds, results) in enumerate(stream):
        for r in results.values():
            if not r.ok:
                outcomes[f"error:{(r.error or '?').split('(')[0]}"] += 1
            elif r.fell_back_to_iod:
                outcomes["IOD-fallback"] += 1
                quality.append(r.orbit_quality)
            else:
                outcomes["LSQ"] += 1
                quality.append(r.orbit_quality)
        n_done += len(results)
        dt = time.time() - t0
        print(f"batch {i}: {len(results)} trajectories (cumulative {n_done} in {dt:.1f}s = {n_done / dt:.0f} fits/s)",
              flush=True)

    print("\noutcomes:")
    for k, v in outcomes.most_common():
        print(f"  {v:7d}  {k}")
    if quality:
        q = np.asarray(quality)
        print(f"quality: min={q.min():.4f} median={np.median(q):.4f} max={q.max():.4f}")


if __name__ == "__main__":
    main()
