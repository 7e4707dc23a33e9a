"""End-to-end batch IOD (and, with ``--lsq``, differential correction) over
MPC 80-column files with the PyTorch port.

The port's form of ``examples/run_full_iod.py``: every trajectory of the
files in one batch, with results that do not depend on the batch.  Imports
only ``outfit_tpu_torch``.

Usage:
    python examples/torch_run_full_iod.py [files.obs ...] [--lsq] [--seed N]
        [--realizations N] [--device DEV[,DEV...]]

``--realizations`` sets the Monte-Carlo noise realizations per triplet (the
batch's size; default IODParams' 20).  ``--device`` takes one device or a
comma-separated list (the trajectories split over them, e.g.
``cuda:0,cuda:1``); default the card when one is present.
"""

import argparse
import os
import sys
import time
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def parse_device(text):
    """``None``, one device name, or a list of them from ``a,b,...``."""
    if text is None or "," not in text:
        return text
    return text.split(",")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "files", nargs="*",
        default=["tests/data/2015AB.obs", "tests/data/8467.obs", "tests/data/33803.obs", "tests/data/K25D50B.obs"],
    )
    ap.add_argument("--lsq", action="store_true", help="run differential correction too")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--realizations", type=int, default=None, help="noise realizations per triplet")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    import torch

    from outfit_tpu_torch import ErrorModel, IODParams, JPLEphem, ObsDataset, fit_full_iod, fit_lsq
    from outfit_tpu_torch.elements.types import EquinoctialElements, equinoctial_to_keplerian

    params = IODParams() if args.realizations is None else IODParams(n_noise_realizations=args.realizations)
    device = parse_device(args.device)
    t0 = time.time()
    eph = JPLEphem.new("analytic:builtin")
    ds = ObsDataset.from_mpc_80_col_files(args.files)
    print(f"loaded {len(ds)} observations / {ds.n_trajectories} trajectories "
          f"from {len(args.files)} files ({time.time() - t0:.1f}s)")

    t0 = time.time()
    fit = fit_lsq if args.lsq else fit_full_iod
    results = fit(ds, eph, params, seed=args.seed, error_model=ErrorModel.fcct14(), device=device)
    print(f"fit in {time.time() - t0:.1f}s\n")

    outcomes = Counter()
    quality_values = []
    for tid, r in sorted(results.items()):
        if args.lsq:
            ok = r.ok and not r.fell_back_to_iod
            quality = r.normalised_rms
            label = "LSQ" if ok else (f"IOD-fallback({r.error})" if r.ok else r.error)
        else:
            ok = r.ok
            quality = r.rms
            label = ("corrected" if r.corrected else "prelim") if ok else r.error
        outcomes[label.split("(")[0] if label else "?"] += 1
        if ok and np.isfinite(quality):
            quality_values.append(quality)
        if r.ok and r.equinoctial is not None:
            kep = equinoctial_to_keplerian(EquinoctialElements(r.epoch, *map(torch.as_tensor, r.equinoctial)))
            print(f"  {tid:12s} {label:14s} quality={quality:10.4f} "
                  f"a={float(kep.semi_major_axis):8.4f} AU  "
                  f"e={float(kep.eccentricity):6.4f}  "
                  f"i={np.degrees(float(kep.inclination)):7.3f} deg")
        else:
            print(f"  {tid:12s} FAILED: {r.error}")

    print("\noutcomes:", dict(outcomes))
    if quality_values:
        print(f"quality: min={min(quality_values):.4f} median={np.median(quality_values):.4f} "
              f"max={max(quality_values):.4f}")


if __name__ == "__main__":
    main()
