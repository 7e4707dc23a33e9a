"""fit_lsq: seeded differential correction over a whole dataset.

Port of the seeded path of ``outfit_tpu/lsq/api.py``
(``fit_lsq(..., initial_orbits=...)`` -> ``_fit_lsq_seeded``), the
reference's resume path (diff_cor ``obs_dataset_api.rs:68-71``):

* convert each trajectory's seed orbit to the batch, run the batched
  correction loops on ``device``,
* fall back to the seed orbit when the correction fails (status != OK),
* return elements + full 6x6 covariance + 1-sigma uncertainties +
  normalised RMS per trajectory.

The JAX package's power-of-two trajectory and observation buckets exist to
bound its recompiles; PyTorch runs eagerly, so the batch here is exactly
the seeded trajectories at the widest trajectory's observation count.
Results do not depend on it: the loops are lane-isolated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from outfit_tpu_torch.elements.uncertainty import uncertainties_from_covariance
from outfit_tpu_torch.errors import (
    BizarreOrbit,
    DifferentialCorrectionDiverged,
    DifferentialCorrectionFailed,
)
from outfit_tpu_torch.iod.api import FitResult
from outfit_tpu_torch.iod.params import IODParams
from outfit_tpu_torch.lsq.config import DifferentialCorrectionConfig
from outfit_tpu_torch.lsq.iteration import SEL_ACTIVE, ObsArrays
from outfit_tpu_torch.lsq.loop import STATUS_OK, check_supported, run_differential_correction
from outfit_tpu_torch.observations.error_model import ErrorModel
from outfit_tpu_torch.observer.cache import ObserverCache
from outfit_tpu_torch.time.scales import Ut1Provider

# kernel status code -> result-error string
_STATUS_NAMES = {
    1: None,
    2: BizarreOrbit.__name__,
    3: DifferentialCorrectionDiverged.__name__,
    4: DifferentialCorrectionFailed.__name__ + "(inversion)",
}

#: lower-triangle index pair of a symmetric 6x6 covariance
_TRIL_I, _TRIL_J = np.tril_indices(6)


def _unpack_cov(tri: np.ndarray) -> np.ndarray:
    """(T, 21) lower triangle -> full symmetric (T, 6, 6)."""
    c = np.zeros(tri.shape[:-1] + (6, 6))
    c[..., _TRIL_I, _TRIL_J] = tri
    c[..., _TRIL_J, _TRIL_I] = tri
    return c


def _status_name(code):
    return _STATUS_NAMES.get(code, f"status={code}")


@dataclass(slots=True)
class LsqResult:
    """Per-trajectory LSQ outcome.

    Parity: ``DifferentialCorrectionOutput`` (diff_cor.rs:202-243) plus the
    fall-back-to-seed semantics of the reference (diff_cor mod.rs:113).
    """

    traj_id: str
    ok: bool
    error: Optional[str] = None
    #: kernel status code (1=STATUS_OK, 2=bizarre, 3=diverged,
    #: 4=inversion-failed; -1 = no kernel run for this row)
    status: int = -1
    fell_back_to_iod: bool = False
    normalised_rms: float = float("inf")
    epoch: float = 0.0
    equinoctial: Optional[np.ndarray] = None  # (6,) ecliptic J2000
    covariance: Optional[np.ndarray] = None  # (6, 6)
    uncertainties: Optional[np.ndarray] = None  # (6,) 1-sigma
    n_active_obs: int = 0
    total_newton_iterations: int = 0
    iod: Optional[FitResult] = None


def _padded_layout(dataset):
    """``(valid, glob_idx)``, both (T_all, n_max): per trajectory (in
    ``traj_ids`` order) its observations' dataset rows, epoch-sorted, and
    which slots are real.  One stable (trajectory, epoch) sort."""
    mjd, ti = dataset.mjd_tt, dataset.traj_index
    n = len(mjd)
    grouped = n == 0 or (
        (ti[1:] >= ti[:-1]).all() and ((mjd[1:] >= mjd[:-1]) | (ti[1:] != ti[:-1])).all()
    )
    order = np.arange(n) if grouped else np.lexsort((mjd, ti))
    ti_sorted = ti[order]
    counts = np.bincount(ti_sorted, minlength=dataset.n_trajectories)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n) - starts[ti_sorted]
    n_max = int(counts.max(initial=1))
    valid = np.zeros((dataset.n_trajectories, n_max), dtype=bool)
    valid[ti_sorted, pos] = True
    glob_idx = np.zeros((dataset.n_trajectories, n_max), np.int64)
    glob_idx[ti_sorted, pos] = order
    return valid, glob_idx


def _gather_obs(dataset, cache, glob, valid, device):
    """The per-trajectory observation tables (``api.py:186-198``): padded
    slots get value 0 and sigma 1."""
    f64 = dict(dtype=torch.float64, device=device)

    def take(col, fill):
        return torch.where(valid, torch.as_tensor(col, **f64)[glob], fill)

    helio = cache.helio_pos_pad.to(device)
    return ObsArrays(
        take(dataset.mjd_tt, 0.0),
        take(dataset.ra, 0.0),
        take(dataset.dec, 0.0),
        take(dataset.ra_error, 1.0),
        take(dataset.dec_error, 1.0),
        torch.where(valid[..., None], helio[glob], 0.0),
        valid,
    )


def _fit_lsq_seeded(dataset, config, initial_orbits, cache, device):
    """Differential correction from an explicit per-trajectory seed map."""
    results: Dict[str, LsqResult] = {}
    rows = []
    for tid in dataset.iter_traj_id():
        iod = initial_orbits.get(tid)
        if iod is None or not iod.ok or iod.equinoctial is None:
            err = iod.error if iod is not None else "no IOD seed"
            results[tid] = LsqResult(tid, ok=False, error=f"IOD failed: {err}", iod=iod)
            continue
        if not np.isfinite(iod.equinoctial).all():
            results[tid] = LsqResult(tid, ok=False, error="IOD seed not finite", iod=iod)
            continue
        rows.append((tid, iod))

    if not rows:
        return results

    valid_all, glob_all = _padded_layout(dataset)
    T = len(rows)
    tid_to_row = {tid: i for i, tid in enumerate(dataset.traj_ids)}
    rsel = np.fromiter((tid_to_row[tid] for tid, _ in rows), np.int64, count=T)
    el0 = np.stack([np.asarray(iod.equinoctial, np.float64) for _, iod in rows])
    ep0 = np.fromiter((iod.epoch for _, iod in rows), np.float64, count=T)
    g_valid = valid_all[rsel]

    valid = torch.as_tensor(g_valid, device=device)
    obs = _gather_obs(dataset, cache, torch.as_tensor(glob_all[rsel], device=device), valid, device)
    f64 = dict(dtype=torch.float64, device=device)
    out = run_differential_correction(
        torch.as_tensor(el0, **f64), torch.as_tensor(ep0, **f64), obs, config
    )
    n_active = ((out.selection == SEL_ACTIVE) & valid).sum(dim=-1)

    status, elements, rms, cov_full, n_active_vec, its = (
        t.cpu().numpy()
        for t in (
            out.status, out.elements, out.normalised_rms, out.covariance,
            n_active, out.total_newton_iterations,
        )
    )
    # the JAX package returns the covariance mirrored from its lower triangle
    cov = _unpack_cov(cov_full[:, _TRIL_I, _TRIL_J])
    sigmas = uncertainties_from_covariance(torch.from_numpy(cov)).numpy()

    ok_l = ((status == STATUS_OK) & np.isfinite(elements).all(axis=1)).tolist()
    nval_l = g_valid.sum(axis=1).tolist()
    rms_l = rms.tolist()
    ep_l = ep0.tolist()
    nact_l = n_active_vec.tolist()
    its_l = its.tolist()
    status_l = status.tolist()
    for t, (tid, iod) in enumerate(rows):
        if ok_l[t]:
            results[tid] = LsqResult(
                tid,
                ok=True,
                status=status_l[t],
                normalised_rms=rms_l[t],
                epoch=ep_l[t],
                equinoctial=elements[t],
                covariance=cov[t],
                uncertainties=sigmas[t],
                n_active_obs=nact_l[t],
                total_newton_iterations=its_l[t],
                iod=iod,
            )
        else:
            # fall back to the seed orbit (diff_cor mod.rs:113)
            results[tid] = LsqResult(
                tid,
                ok=True,
                error=_status_name(status_l[t]),
                status=status_l[t],
                fell_back_to_iod=True,
                normalised_rms=float(iod.rms),
                epoch=float(iod.epoch),
                equinoctial=np.array(iod.equinoctial),
                n_active_obs=nval_l[t],
                iod=iod,
            )
    return results


def fit_lsq(
    dataset,
    ephem,
    iod_params: IODParams = IODParams(),
    config: DifferentialCorrectionConfig = DifferentialCorrectionConfig(),
    ut1: Optional[Ut1Provider] = None,
    error_model: Optional[ErrorModel] = None,
    initial_orbits: Optional[Dict[str, FitResult]] = None,
    cache: Optional[ObserverCache] = None,
    device=None,
) -> Dict[str, LsqResult]:
    """Differential correction for every trajectory of the dataset, from
    the seed orbits in ``initial_orbits`` (parity: diff_cor
    obs_dataset_api.rs:68-71).

    ``device``: where the observer cache and the correction run; default
    ``"cuda"`` when a card is present, else ``"cpu"``.  ``iod_params``
    gives ``gap_max`` for the batch RMS correction.  Without ``initial_orbits`` the Gauss IOD stage would run, which is not
    ported yet: that raises ``NotImplementedError``.
    """
    if initial_orbits is None:
        raise NotImplementedError(
            "fit_lsq without initial_orbits runs Gauss IOD, which is not ported "
            "yet (ROADMAP: port queue, Gauss IOD and unseeded fit_lsq)"
        )
    check_supported(config)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if error_model is not None:
        dataset.apply_error_model(error_model)
        dataset.apply_batch_rms_correction(iod_params.gap_max)
    if np.isnan(dataset.ra_error).any():
        dataset.apply_error_model(ErrorModel.fcct14())
        dataset.apply_batch_rms_correction(iod_params.gap_max)
    if cache is None:
        cache = ObserverCache.build(dataset, ephem, ut1, device=device)
    return _fit_lsq_seeded(dataset, config, initial_orbits, cache, device)
