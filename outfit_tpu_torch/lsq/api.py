"""fit_lsq: IOD + differential correction over a whole dataset.

Port of ``outfit_tpu/lsq/api.py`` (float64, two-body):

* without ``initial_orbits``: Gauss IOD (:func:`outfit_tpu_torch.iod.api.
  fit_full_iod`) on the same observer cache and device, then the seeded
  correction from its results (the JAX package fuses the two stages on
  the device; the per-trajectory results are the same),
* with ``initial_orbits``: the reference's resume path (diff_cor
  ``obs_dataset_api.rs:68-71``),
* the batched correction loops run on ``device``; a trajectory whose
  correction fails (status != OK) falls back to its seed orbit,
* per trajectory: elements + full 6x6 covariance + 1-sigma uncertainties +
  normalised RMS.

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
from outfit_tpu_torch.iod.api import (
    FitResult,
    _fit_full_iod,
    _gather_obs_tables,
    _padded_layout,
    base_arrays,
    check_supported as check_iod_supported,
    prepare_dataset,
)
from outfit_tpu_torch.iod.params import IODParams
from outfit_tpu_torch.lsq.config import DifferentialCorrectionConfig
from outfit_tpu_torch.lsq.iteration import SEL_ACTIVE, ObsArrays
from outfit_tpu_torch.lsq.loop import STATUS_OK, check_supported, run_differential_correction
from outfit_tpu_torch.observations.error_model import ErrorModel
from outfit_tpu_torch.observer.cache import ObserverCache
from outfit_tpu_torch.time.scales import Ut1Provider
from outfit_tpu_torch.utils.tensors import resolve_device

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
    glob = torch.as_tensor(glob_all[rsel], device=device)
    obs = ObsArrays(*_gather_obs_tables(base_arrays(dataset, cache, device), glob, valid), valid)
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


def _fit_lsq(
    dataset, ephem, iod_params, config, seed, ut1, error_model, initial_orbits, cache, device,
    draws=None,
) -> Dict[str, LsqResult]:
    """:func:`fit_lsq` with an optional IOD noise source (``draws``, see
    :func:`outfit_tpu_torch.iod.api._fit_full_iod`)."""
    check_supported(config)
    if initial_orbits is None:
        check_iod_supported(iod_params)
    device = resolve_device(device)
    prepare_dataset(dataset, iod_params.gap_max, error_model)
    if cache is None:
        cache = ObserverCache.build(dataset, ephem, ut1, device=device)
    if initial_orbits is not None:
        return _fit_lsq_seeded(dataset, config, initial_orbits, cache, device)
    iod = _fit_full_iod(dataset, ephem, iod_params, seed, ut1, None, cache, device, draws)
    res = _fit_lsq_seeded(dataset, config, iod, cache, device)
    return {tid: res[tid] for tid in dataset.traj_ids}


def fit_lsq(
    dataset,
    ephem,
    iod_params: IODParams = IODParams(),
    config: DifferentialCorrectionConfig = DifferentialCorrectionConfig(),
    seed: int = 0,
    ut1: Optional[Ut1Provider] = None,
    error_model: Optional[ErrorModel] = None,
    initial_orbits: Optional[Dict[str, FitResult]] = None,
    cache: Optional[ObserverCache] = None,
    device=None,
) -> Dict[str, LsqResult]:
    """IOD + differential correction for every trajectory of the dataset.

    Without ``initial_orbits``, Gauss IOD (``iod_params``, ``seed``) seeds
    the correction and the results come in dataset order; with it, the
    correction resumes from those orbits (parity: diff_cor
    obs_dataset_api.rs:68-71).  ``iod_params.gap_max`` drives the batch RMS
    correction either way.  ``device``: where the observer cache, IOD and
    correction run; default ``"cuda"`` when a card is present, else
    ``"cpu"``.  The parameters are the JAX package's, in its order, with
    ``device`` in place of ``mesh`` (and no ``as_table``).
    """
    return _fit_lsq(
        dataset, ephem, iod_params, config, seed, ut1, error_model, initial_orbits, cache, device
    )
