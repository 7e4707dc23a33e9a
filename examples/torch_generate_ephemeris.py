"""End-to-end ephemeris generation with the PyTorch port: fit an orbit from
MPC observations, then predict apparent positions and observation geometry
over a date range.

The port's form of ``examples/generate_ephemeris.py``: fit ->
``EphemerisRequest`` (a range of epochs for one observer) -> per-entry
results with errors as data.  Imports only ``outfit_tpu_torch``.

Usage:
    python examples/torch_generate_ephemeris.py [file.obs ...] [--days N] [--step D] [--device DEV]

Defaults to the fixture tests/data/2015AB.obs, 30 days in 5-day steps, on
the card when one is present (``--device cpu`` asks for the CPU).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("files", nargs="*", default=["tests/data/2015AB.obs"])
    ap.add_argument("--days", type=float, default=30.0, help="length of the predicted range")
    ap.add_argument("--step", type=float, default=5.0, help="days between predicted epochs")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    from outfit_tpu_torch import (
        DifferentialCorrectionConfig,
        EphemerisMode,
        EphemerisRequest,
        IODParams,
        JPLEphem,
        ObsDataset,
        Observer,
        compute_ephemeris,
        fit_lsq,
    )
    from outfit_tpu_torch.conversion import dec_sdms_prec, ra_hms_prec

    ds = ObsDataset.from_mpc_80_col_files(args.files)
    eph = JPLEphem("analytic:builtin")

    print(f"fitting {ds.n_trajectories} trajectories from {len(args.files)} file(s)...")
    fits = fit_lsq(
        ds, eph, iod_params=IODParams(precision="mixed"),
        config=DifferentialCorrectionConfig(precision="mixed", divergence_grace_iterations=2),
        seed=0, device=args.device,
    )

    observer = Observer.geocenter()
    for tid, r in sorted(fits.items()):
        if not r.ok:
            print(f"\n{tid}: fit failed ({r.error}) — skipping ephemeris")
            continue
        kep = r.keplerian
        t0 = float(r.epoch)
        req = EphemerisRequest().add(observer, EphemerisMode.range(t0, t0 + args.days, args.step))
        res = compute_ephemeris(kep, req, eph, device=args.device)

        print(f"\n{tid}  (a={float(kep.semi_major_axis):.4f} AU, "
              f"e={float(kep.eccentricity):.4f}, nRMS={r.normalised_rms:.3f})")
        print(f"  {'MJD (TT)':>12s}  {'RA':>13s}  {'Dec':>13s}  {'geo dist':>9s}  {'elong':>6s}  {'phase':>6s}")
        for e in res.successes():
            p, g = e.value.position, e.value.geometry
            hh, mm, ss = ra_hms_prec(p.ra, 2)
            sgn, dd, dm, dsec = dec_sdms_prec(p.dec, 1)
            print(f"  {e.epoch:12.3f}  {hh:02d}h{mm:02d}m{ss:05.2f}s  "
                  f"{sgn}{dd:02d}d{dm:02d}'{dsec:04.1f}\"  "
                  f"{p.geocentric_distance:8.4f}AU  "
                  f"{np.degrees(g.solar_elongation):5.1f}d  "
                  f"{np.degrees(g.phase_angle):5.1f}d")
        n_err = sum(1 for _ in res.errors())
        if n_err:
            print(f"  ({n_err} epochs failed)")


if __name__ == "__main__":
    main()
