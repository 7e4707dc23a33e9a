"""Write ``tests/data/iod_seeds_analytic.json``: Gauss IOD seeds of the fixtures.

The seeded least-squares path (``fit_lsq(..., initial_orbits=...)``) of both
packages starts from these orbits.  They come from the JAX package's
``fit_full_iod`` on the analytic ephemeris over MJD 53500-61500, default
``IODParams``, ``seed=42`` and the FCCT14 error model, one fixture file at a
time.  Floats are written with ``repr`` precision, so they read back bit for
bit; a reader needs neither JAX nor this script.

Run from the repository root::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/make_iod_seeds.py
"""

from __future__ import annotations

import json
import os

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURES = ("2015AB", "8467", "33803", "K25D50B")
SEEDS_PATH = os.path.join(DATA, "iod_seeds_analytic.json")


def _row(r) -> dict:
    def vec(v):
        return None if v is None else [float(x) for x in v]

    return {
        "traj_id": r.traj_id,
        "ok": bool(r.ok),
        "rms": float(r.rms),
        "epoch": float(r.epoch),
        "kind": int(r.kind),
        "elements": vec(r.elements),
        "equinoctial": vec(r.equinoctial),
    }


def compute_seeds() -> dict:
    """``{fixture: {traj_id: FitResult fields}}`` from ``fit_full_iod``."""
    # the observatory catalog would otherwise try to download the MPC list
    os.environ.setdefault("OUTFIT_NO_DOWNLOAD", "1")
    from outfit_tpu.ephem import JPLEphem
    from outfit_tpu.iod import IODParams
    from outfit_tpu.iod.api import fit_full_iod
    from outfit_tpu.observations import ErrorModel, ObsDataset

    eph = JPLEphem.analytic(53500.0, 61500.0)
    out = {}
    for name in FIXTURES:
        ds = ObsDataset.from_mpc_80_col(os.path.join(DATA, f"{name}.obs"))
        res = fit_full_iod(
            ds, eph, IODParams(), seed=42, error_model=ErrorModel.fcct14(),
            mesh=None,
        )
        out[name] = {tid: _row(r) for tid, r in res.items()}
    return out


def main():
    seeds = compute_seeds()
    with open(SEEDS_PATH, "w", encoding="utf-8") as fh:
        json.dump(seeds, fh, indent=1, allow_nan=True)
        fh.write("\n")
    print(f"wrote {SEEDS_PATH}")


if __name__ == "__main__":
    main()
