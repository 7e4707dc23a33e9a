"""What the fitting drivers share: the port's inputs built from the
benchmark's arrays, the port's settings from a configuration file, and
the port's outputs read into plain per-row arrays."""

import numpy as np

#: the LSQ status the program reports for a converged correction
CONVERGED = 1


def ephemeris(run):
    """The deployment's ephemeris source on the run's first device."""
    from outfit_tpu_torch import JPLEphem

    span = run.config["ephemeris"]["span_mjd"]
    return JPLEphem.analytic(*span).to(run.devices[0])


def settings(config):
    """(IODParams, DifferentialCorrectionConfig) of a configuration file."""
    from outfit_tpu_torch import DifferentialCorrectionConfig, IODParams
    from outfit_tpu_torch.elements.types import EquinoctialLimits
    from outfit_tpu_torch.lsq.config import OutlierRejectionConfig

    c = dict(config["correction"])
    orc = OutlierRejectionConfig(c.pop("chi_squared_rejection_threshold"), c.pop("chi_squared_recovery_threshold"))
    limits = EquinoctialLimits(**c.pop("orbital_limits"))
    return IODParams(**config["iod"]), DifferentialCorrectionConfig(outlier_rejection=orc, orbital_limits=limits, **c)


def dataset(mjd, ra, dec, sigma_ra, sigma_dec, traj_index, observer_index, observers, prefix):
    """An ``ObsDataset`` of flat observation arrays."""
    from outfit_tpu_torch import ObsDataset

    ds = ObsDataset()
    n = len(mjd)
    ds.mjd_tt, ds.ra, ds.dec, ds.ra_error, ds.dec_error = mjd, ra, dec, sigma_ra, sigma_dec
    ds.traj_index = traj_index
    ds.observer_index = observer_index
    ds.traj_ids = [f"{prefix}{i:06d}" for i in range(int(traj_index.max()) + 1)]
    ds.observers = observers
    ds.mag = np.full(n, np.nan)
    ds.catalog = np.full(n, " ", dtype="U1")
    return ds


def rows_from_table(table):
    """Per-row arrays of an ``LsqTable``."""
    return dict(
        present=np.ones(len(table), bool), converged=table.converged & (table.status == CONVERGED),
        status=table.status.astype(np.int64), epoch=table.epoch, elements=table.equinoctial,
        covariance=table.covariance, rms=table.normalised_rms, n_active=table.n_active_obs,
        newton=table.total_newton_iterations, fell_back=table.fell_back_to_iod, iod_ok=table.iod_ok,
        iod_rms=table.iod_rms, iod_epoch=table.iod_epoch, iod_elements=table.iod_equinoctial,
    )


def rows_from_dict(results, traj_ids):
    """Per-row arrays of a ``{traj_id: LsqResult}`` dict, in ``traj_ids``
    order; a trajectory without an entry is not ``present``."""
    T = len(traj_ids)
    nan6 = np.full(6, np.nan)
    out = dict(present=np.zeros(T, bool), converged=np.zeros(T, bool), status=np.full(T, -1),
               epoch=np.full(T, np.nan), elements=np.full((T, 6), np.nan), covariance=np.full((T, 6, 6), np.nan),
               rms=np.full(T, np.nan), n_active=np.zeros(T, np.int64), newton=np.zeros(T, np.int64),
               fell_back=np.zeros(T, bool), iod_ok=np.zeros(T, bool), iod_rms=np.full(T, np.nan),
               iod_epoch=np.full(T, np.nan), iod_elements=np.full((T, 6), np.nan))
    for i, tid in enumerate(traj_ids):
        r = results.get(tid)
        if r is None:
            continue
        out["present"][i] = True
        out["status"][i] = r.status
        out["converged"][i] = r.ok and r.status == CONVERGED and not r.fell_back_to_iod
        out["epoch"][i] = r.epoch
        out["elements"][i] = r.equinoctial if r.equinoctial is not None else nan6
        if r.covariance is not None:
            out["covariance"][i] = r.covariance
        out["rms"][i] = r.normalised_rms
        out["n_active"][i] = r.n_active_obs
        out["newton"][i] = r.total_newton_iterations
        out["fell_back"][i] = r.fell_back_to_iod
    return out


def failed_rows(rows):
    """Rows without a result, or reported converged with non-finite
    elements or covariance."""
    bad = rows["converged"] & ~(np.isfinite(rows["elements"]).all(1) & np.isfinite(rows["covariance"]).all((1, 2)))
    return ~rows["present"] | bad


def tally(run, rows):
    """(attempted, failed) of the window; each record gains its counts of
    converged rows and Newton iterations, which the metrics read."""
    failed = 0
    for r in run.records:
        x = rows(r)
        r["converged"] = int(x["converged"].sum())
        r["newton"] = int(x["newton"].sum())
        failed += int(failed_rows(x).sum())
    return sum(r["n"] for r in run.records), failed
