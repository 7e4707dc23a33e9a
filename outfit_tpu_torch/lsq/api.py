"""fit_lsq and its service modes: IOD + differential correction over
whole datasets.

Port of ``outfit_tpu/lsq/api.py`` (two-body or N-body propagator, float64
or mixed precision):

* without ``initial_orbits``: Gauss IOD (:func:`outfit_tpu_torch.iod.api.
  fit_full_iod`) on the same observer cache and device, then the seeded
  correction from its results (the JAX package fuses the two stages on
  the device; the per-trajectory results are the same),
* with ``initial_orbits``: the reference's resume path (diff_cor
  ``obs_dataset_api.rs:68-71``),
* the batched correction loops run on ``device``; a trajectory whose
  correction fails (status != OK) falls back to its seed orbit,
* per trajectory: elements + full 6x6 covariance + 1-sigma uncertainties +
  normalised RMS, as a ``{traj_id: LsqResult}`` dict or, with
  ``as_table=True``, a columnar :class:`outfit_tpu_torch.lsq.table.LsqTable`,
* the service modes: :func:`fit_lsq_stream` (datasets fitted one by one
  as the caller asks for them), :func:`fit_lsq_escalating` and
  :func:`fit_lsq_stream_escalating` (failures refitted with richer stages),
  and :func:`fit_lsq_dispatch` / :func:`fit_lsq_finalize`,
* ``device`` naming several devices (the JAX package's ``mesh``): each fits
  a contiguous chunk of the trajectories (:func:`_fit_lsq`).

The JAX package's power-of-two trajectory and observation buckets exist to
bound its recompiles; PyTorch runs eagerly, so the batch here is exactly
the seeded trajectories at the widest trajectory's observation count.
Results do not depend on it: the loops are lane-isolated.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from outfit_tpu_torch import trace
from outfit_tpu_torch.elements.types import (
    EquinoctialElements,
    equinoctial_to_keplerian,
    jacobian_equinoctial_to_keplerian,
)
from outfit_tpu_torch.elements.uncertainty import propagate_covariance, uncertainties_from_covariance
from outfit_tpu_torch.errors import (
    BizarreOrbit,
    DifferentialCorrectionDiverged,
    DifferentialCorrectionFailed,
)
from outfit_tpu_torch.iod.api import (
    FitResult,
    _gather_bias,
    _gather_obs_tables,
    _IodBatch,
    _padded_layout,
    device_bases,
    prepare_dataset,
)
from outfit_tpu_torch.iod.params import IODParams
from outfit_tpu_torch.lsq.config import DifferentialCorrectionConfig
from outfit_tpu_torch.lsq.iteration import SEL_ACTIVE, ObsArrays
from outfit_tpu_torch.lsq.loop import STATUS_OK, check_supported, differential_correction
from outfit_tpu_torch.observations.error_model import ErrorModel
from outfit_tpu_torch.observer.cache import ObserverCache
from outfit_tpu_torch.observations.dataset import ObsDataset
from outfit_tpu_torch.time.scales import Ut1Provider
from outfit_tpu_torch.parallel.sharding import chunk_bounds, fit_devices, map_devices
from outfit_tpu_torch.utils.tensors import device_constant

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

    @property
    def orbit_quality(self) -> float:
        """Scalar fit quality (parity: ``FitOrbitResult::orbit_quality``,
        constants.rs:157-162): the normalised RMS of a converged correction,
        the IOD RMS on fallback."""
        if self.fell_back_to_iod and self.iod is not None:
            return self.iod.rms
        return self.normalised_rms

    def _eq(self):
        return EquinoctialElements(
            *(torch.as_tensor(x, dtype=torch.float64) for x in (self.epoch, *self.equinoctial))
        )

    @property
    def orbital_elements(self):
        """Equinoctial element set of the fit (parity:
        ``FitOrbitResult::orbital_elements``, constants.rs:169-174)."""
        return None if self.equinoctial is None else self._eq()

    @property
    def keplerian(self):
        return None if self.equinoctial is None else equinoctial_to_keplerian(self._eq())

    @property
    def keplerian_covariance(self):
        """The 6x6 covariance propagated to Keplerian elements,
        J Sigma J^T (parity: ``OrbitalElements::to_keplerian``,
        orbit_type/mod.rs:323-443)."""
        if self.covariance is None or self.equinoctial is None:
            return None
        j = jacobian_equinoctial_to_keplerian(self._eq())
        return propagate_covariance(torch.as_tensor(self.covariance, dtype=torch.float64), j).numpy()

    @property
    def keplerian_uncertainties(self):
        """Per-element 1-sigma in Keplerian elements."""
        cov = self.keplerian_covariance
        if cov is None:
            return None
        return np.sqrt(np.maximum(np.diag(cov), 0.0))


#: Reference-name alias (``DifferentialCorrectionOutput``, diff_cor.rs:202-225).
DifferentialCorrectionOutput = LsqResult


def _screen_seeds(tids, initial_orbits):
    """``(results, rows)`` of ``tids``: the error results of those without a
    usable seed, and ``[(tid, seed)]`` of the rows to correct."""
    results: Dict[str, LsqResult] = {}
    rows = []
    for tid in tids:
        iod = initial_orbits.get(tid)
        if iod is None or not iod.ok or iod.equinoctial is None:
            err = iod.error if iod is not None else "no IOD seed"
            results[tid] = LsqResult(tid, ok=False, error=f"IOD failed: {err}", iod=iod)
            continue
        if not np.isfinite(iod.equinoctial).all():
            results[tid] = LsqResult(tid, ok=False, error="IOD seed not finite", iod=iod)
            continue
        rows.append((tid, iod))
    return results, rows


def _correct(layout, row_of, rows, config, base, device, slim=False, ephem=None):
    """Differential correction of ``rows`` (``[(tid, seed)]``) on ``device``,
    every row at the dataset's padded width.  Returns the per-row host
    arrays (status, elements, RMS, covariance lower triangle, active
    observations, iterations) and the pre-warm's trip count.  ``slim``: the
    covariance crosses to the host as float32.  ``ephem``: for an N-body
    ``config.propagator`` (moved to ``device`` here)."""
    with trace.span("correct"):
        valid_all, glob_all = layout
        T = len(rows)
        rsel = np.fromiter((row_of[tid] for tid, _ in rows), np.int64, count=T)
        el0 = np.stack([np.asarray(iod.equinoctial, np.float64) for _, iod in rows])
        ep0 = np.fromiter((iod.epoch for _, iod in rows), np.float64, count=T)

        valid = torch.as_tensor(valid_all[rsel], device=device)
        glob = torch.as_tensor(glob_all[rsel], device=device)
        obs = ObsArrays(*_gather_obs_tables(base, glob, valid), valid, *_gather_bias(base, glob, valid))
        f64 = dict(dtype=torch.float64, device=device)
        out, prewarm = differential_correction(
            torch.as_tensor(el0, **f64), torch.as_tensor(ep0, **f64), obs, config,
            ephem=ephem.to(device) if config.propagator.nbody else None,
        )
        n_active = ((out.selection == SEL_ACTIVE) & valid).sum(dim=-1)
        # the JAX package returns the covariance mirrored from its lower triangle
        cov_tri = out.covariance[:, device_constant(_TRIL_I, device, torch.int64),
                                 device_constant(_TRIL_J, device, torch.int64)]
        if slim:
            cov_tri = cov_tri.float()
        arrays = [
            trace.sites.lsq_copyback.cpu(t).numpy()
            for t in (out.status, out.elements, out.normalised_rms, cov_tri, n_active, out.total_newton_iterations)
        ]
        return arrays, prewarm


def _add_results(results, rows, parts, valid_all, row_of):
    """The ``LsqResult`` of each of ``rows`` added to ``results``, from the
    :func:`_correct` outputs of its consecutive chunks ``parts``.  A row's
    iteration count holds its chunk's pre-warm trip count; one batch's would
    be the largest chunk's (its slowest row), and every row gets that."""
    prewarm = max(p for _, p in parts)
    status, elements, rms, cov_tri, n_active_vec = (
        np.concatenate([a[k] for a, _ in parts]) for k in range(5)
    )
    its = np.concatenate([a[5] + (prewarm - p) for a, p in parts])
    cov = _unpack_cov(cov_tri.astype(np.float64, copy=False))
    sigmas = uncertainties_from_covariance(torch.from_numpy(cov)).numpy()

    ok_l = ((status == STATUS_OK) & np.isfinite(elements).all(axis=1)).tolist()
    rsel = np.fromiter((row_of[tid] for tid, _ in rows), np.int64, count=len(rows))
    nval_l = valid_all[rsel].sum(axis=1).tolist()
    rms_l = rms.tolist()
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
                epoch=float(iod.epoch),
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


def _as_table(dataset, res, minimal=False):
    """The columnar form of a result dict.  The port builds it from the
    per-row results (the JAX package's fused finalize fills the columns
    directly): rows materialize identically, and an IOD failure carries
    its error text in ``host_errors`` under ``IOD_HOST_SCREENED``.
    ``minimal``: the converged rows' IOD element columns are NaN (the JAX
    package's ``minimal_fetch`` contract)."""
    from outfit_tpu_torch.lsq.table import LsqTable

    table = LsqTable.from_results(dataset.traj_ids, res)
    if minimal:
        table.iod_elements[table.converged] = np.nan
        table.iod_equinoctial[table.converged] = np.nan
    return table


def _check_fetch_modes(as_table, minimal_fetch):
    if minimal_fetch and not as_table:
        raise ValueError(
            "minimal_fetch=True requires as_table=True (the per-row dict "
            "materializes every row's IOD FitResult eagerly)"
        )


def _fit_lsq(
    dataset, ephem, iod_params, config, seed, ut1, error_model, initial_orbits, cache, device,
    draws=None, as_table=False, slim=False, minimal=False,
):
    """:func:`fit_lsq` with an optional IOD noise source (``draws``, see
    :func:`outfit_tpu_torch.iod.api._fit_full_iod`) and the stream's
    ``slim``/``minimal`` result contracts (see :func:`fit_lsq_stream`).

    Over several devices, what sees the whole batch runs once (the dataset
    preparation, the observer cache on the first device, the padded layout,
    the IOD's triplet counts); then each device, in a worker thread of its
    own, fits its chunk of the IOD's kept rows and then its chunk of the
    seeded rows (:func:`chunk_bounds`), every row at the whole dataset's
    widths, and the results join in dataset order."""
    with trace.span("fit"):
        with trace.span("fit.prepare"):
            _check_fetch_modes(as_table, minimal)
            check_supported(config)
            devices = fit_devices(device)
            prepare_dataset(dataset, iod_params.gap_max, error_model)
            layout = _padded_layout(dataset)
        if cache is None:
            cache = ObserverCache.build(dataset, ephem, ut1, device=devices[0])
        bases = device_bases(dataset, cache)
        seeded = initial_orbits is not None
        if not seeded:
            initial_orbits = _IodBatch(dataset, iod_params.validated(), seed, layout, devices, draws, slim).fit(
                devices, bases)
        with trace.span("fit.prepare"):
            res, rows = _screen_seeds(dataset.traj_ids, initial_orbits)
            row_of = {tid: i for i, tid in enumerate(dataset.traj_ids)}
        parts = []
        if rows:

            def work(device, chunk):
                a, b = chunk
                if a == b:
                    return None
                return _correct(layout, row_of, rows[a:b], config, bases(device), device, slim, ephem)

            parts = map_devices(devices, work, chunk_bounds([(0, len(rows))], len(devices)))
        with trace.span("fit.assemble"):
            if rows:
                _add_results(res, rows, [p for p in parts if p is not None], layout[0], row_of)
            if not seeded:
                res = {tid: res[tid] for tid in dataset.traj_ids}
            return _as_table(dataset, res, minimal) if as_table else res


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
    as_table: bool = False,
    device=None,
):
    """IOD + differential correction for every trajectory of the dataset.

    Without ``initial_orbits``, Gauss IOD (``iod_params``, ``seed``) seeds
    the correction and the results come in dataset order; with it, the
    correction resumes from those orbits (parity: diff_cor
    obs_dataset_api.rs:68-71).  ``iod_params.gap_max`` drives the batch RMS
    correction either way.  ``as_table=True`` returns a columnar
    :class:`~outfit_tpu_torch.lsq.table.LsqTable` instead of the
    ``{traj_id: LsqResult}`` dict.  ``device``: where the observer cache,
    IOD and correction run: one device; a list of devices (names may
    repeat), each fitting a contiguous chunk of the trajectories in a
    worker thread of its own, the observer cache built once on the first,
    every result bitwise the single-device one; ``"auto"``, every visible
    CUDA card; None, ``"auto"`` when a card is present, else the CPU.  The
    parameters are the JAX package's, in its order, with ``device`` last in
    place of ``mesh`` (``mesh=`` is a ``TypeError``).
    """
    return _fit_lsq(
        dataset, ephem, iod_params, config, seed, ut1, error_model, initial_orbits, cache, device,
        as_table=as_table,
    )


@dataclass
class PendingLsq:
    """A fit made by :func:`fit_lsq_dispatch`, handed back by
    :func:`fit_lsq_finalize`.  The JAX package dispatches the device work
    and fetches it at finalize; the port's fit reads the device once per
    loop trip, so the dispatch runs it to its end and ``results`` holds
    what the finalize returns (the dict, or the ``LsqTable`` when
    dispatched with ``as_table=True``)."""

    dataset: object
    results: object


def fit_lsq_dispatch(
    dataset,
    ephem,
    iod_params: IODParams = IODParams(),
    config: DifferentialCorrectionConfig = DifferentialCorrectionConfig(),
    seed: int = 0,
    ut1: Optional[Ut1Provider] = None,
    error_model: Optional[ErrorModel] = None,
    cache: Optional[ObserverCache] = None,
    slim_fetch: bool = False,
    as_table: bool = False,
    minimal_fetch: bool = False,
    device=None,
) -> PendingLsq:
    """IOD + differential correction of the dataset, for
    :func:`fit_lsq_finalize`: ``fit_lsq_finalize(fit_lsq_dispatch(...))``
    is ``fit_lsq(...)`` on the same arguments.  ``slim_fetch``,
    ``as_table`` and ``minimal_fetch`` mean what they mean in
    :func:`fit_lsq_stream` (``minimal_fetch=True`` requires
    ``as_table=True``); ``device`` as in :func:`fit_lsq`.  The parameters
    are the JAX package's, in its order, with ``device`` last in place of
    ``mesh``."""
    return PendingLsq(dataset, _fit_lsq(
        dataset, ephem, iod_params, config, seed, ut1, error_model, None, cache, device,
        as_table=as_table, slim=slim_fetch, minimal=minimal_fetch,
    ))


def fit_lsq_finalize(pending: PendingLsq):
    """The results of a dispatched fit: the ``{traj_id: LsqResult}`` dict,
    or the ``LsqTable`` when dispatched with ``as_table=True``; a second
    call returns them again."""
    return pending.results


def _fit_lsq_stream(
    datasets, ephem, iod_params, config, seed, ut1, error_model, slim_fetch, as_table, minimal_fetch, device,
    draws=None,
):
    _check_fetch_modes(as_table, minimal_fetch)
    check_supported(config)
    return (
        (ds, _fit_lsq(ds, ephem, iod_params, config, seed, ut1, error_model, None, None, device,
                      draws, as_table, slim_fetch, minimal_fetch))
        for ds in datasets
    )


def fit_lsq_stream(
    datasets,
    ephem,
    iod_params: IODParams = IODParams(),
    config: DifferentialCorrectionConfig = DifferentialCorrectionConfig(),
    seed: int = 0,
    ut1: Optional[Ut1Provider] = None,
    error_model: Optional[ErrorModel] = None,
    depth: int = 2,
    prefetch: bool = True,
    slim_fetch: bool = False,
    as_table: bool = False,
    minimal_fetch: bool = False,
    device=None,
):
    """Fits over a stream of datasets; yields ``(dataset, results)`` in
    input order, each dataset fitted when the caller asks for it.  Each
    dataset's results are bitwise those of a sequential :func:`fit_lsq`.

    ``depth`` and ``prefetch`` are accepted and have no effect: the JAX
    package overlaps datasets through asynchronous dispatch, while the
    port's fits read the device once per loop trip, and a worker thread
    that overlapped them measured no faster than fitting one by one.

    ``slim_fetch=True``: the covariance and the IOD's RMS and native-kind
    elements cross to the host as float32 (so the covariance, the 1-sigma
    values, the IOD reporting columns and the fallback rows' RMS are their
    float32 rounding); LSQ elements, RMS and status, the equinoctial seed
    and the epochs stay exact.  ``as_table=True``: each dataset's results as
    an :class:`~outfit_tpu_torch.lsq.table.LsqTable`.  ``minimal_fetch=True``
    (requires ``as_table=True``): the converged rows' IOD element columns
    are NaN, every other column is unchanged.  The parameters are the JAX
    package's, in its order, with ``device`` last in place of ``mesh``.
    """
    return _fit_lsq_stream(
        datasets, ephem, iod_params, config, seed, ut1, error_model, slim_fetch, as_table, minimal_fetch, device,
    )


def _default_retry(r):
    return (not r.ok) or r.fell_back_to_iod


def _fit_lsq_escalating(dataset, ephem, stages, seed, ut1, error_model, retry_if, device, draws=None):
    if not stages:
        raise ValueError("fit_lsq_escalating needs at least one (params, config) stage")
    retry_if = retry_if or _default_retry
    cur = dataset
    results: Dict[str, LsqResult] = {}
    for k, (params, cfg) in enumerate(stages):
        res = _fit_lsq(cur, ephem, params, cfg, seed, ut1, error_model, None, None, device, draws)
        results.update(res)
        if k == len(stages) - 1:
            break
        retry = {tid for tid, r in res.items() if retry_if(r)}
        parts = [g for tid, g in cur.trajectory_groups() if tid in retry and g.size]
        if not parts:
            break
        cur = cur.subset(np.concatenate(parts))
    return results


def fit_lsq_escalating(
    dataset,
    ephem,
    stages,
    seed: int = 0,
    ut1: Optional[Ut1Provider] = None,
    error_model: Optional[ErrorModel] = None,
    retry_if=None,
    device=None,
):
    """Tiered fitting: stage 0 fits every trajectory; those that fail it
    (``retry_if(result)``, default: not converged through the least-squares
    loop, ``not r.ok or r.fell_back_to_iod``) are refitted with each richer
    stage, on the failing subset only.  ``stages``: ``(IODParams,
    DifferentialCorrectionConfig)`` pairs, lean to rich.  The noise seeds
    fold in the trajectory id, so a trajectory's stage-k result does not
    depend on which others escalated with it.  Returns the
    ``{traj_id: LsqResult}`` dict in dataset order of first appearance."""
    return _fit_lsq_escalating(dataset, ephem, stages, seed, ut1, error_model, retry_if, device)


def _fit_lsq_stream_escalating(
    datasets, ephem, stages, seed, ut1, error_model, retry_if, flush_every, device, draws=None, **stream_kw,
):
    if not stages:
        raise ValueError("needs at least one (params, config) stage")
    user_retry = retry_if is not None
    retry_if = retry_if or _default_retry
    for name in ("depth", "prefetch"):  # accepted, no effect (fit_lsq_stream)
        stream_kw.pop(name, None)
    stream_kw = dict(dict(as_table=True, slim_fetch=False, minimal_fetch=False), **stream_kw)
    params0, cfg0 = stages[0]
    for _, cfg in stages[1:]:
        check_supported(cfg)
    held = []  # [(dataset, results, [failed tids])]

    def failed_tids(res):
        if isinstance(res, dict):
            return [tid for tid, r in res.items() if retry_if(r)]
        # the default predicate retries exactly the rows whose converged
        # flag is down; a user predicate sees every row
        tids = np.asarray(res.traj_ids, object)
        if not user_retry:
            tids = tids[~np.asarray(res.converged)]
        return [tid for tid in tids if retry_if(res.result(tid))]

    def flush():
        """One batched pass per richer stage over the held datasets'
        failures; patch them in and yield the held datasets in order."""
        if held:
            with trace.span("escalate"):
                refit()
        out = [(ds, res) for ds, res, _ in held]
        held.clear()
        return out

    def refit():
        parts, prefixes = [], []
        for hi, (ds, _res, fails) in enumerate(held):
            fset = set(fails)
            rows = [g for tid, g in ds.trajectory_groups() if tid in fset and g.size]
            if rows:
                parts.append(ds.subset(np.concatenate(rows)))
                prefixes.append(str(hi))
        if not parts:
            trace.escalation.add(flushes=1)
            return
        # held-index-prefixed ids: the same id may occur in several
        # held datasets, and the prefix selects the escalated noise
        cur = ObsDataset.concat(parts, rename=lambda k, tid: f"{prefixes[k]}|{tid}")
        trace.escalation.add(flushes=1, rows=len(cur.traj_ids))
        last = {}  # each escalated row's result at the last stage it ran
        for k, (p, c) in enumerate(stages[1:], start=1):
            res_k = _fit_lsq(cur, ephem, p, c, seed, ut1, error_model, None, None, device, draws)
            clean = {}
            for mtid, r in res_k.items():
                hi_s, tid = mtid.split("|", 1)
                rr = dataclasses.replace(r, traj_id=tid)
                clean[mtid] = rr
                tgt = held[int(hi_s)][1]
                if isinstance(tgt, dict):
                    tgt[tid] = rr
                else:
                    tgt.patch_row(tid, rr)
            last.update(clean)
            if k == len(stages) - 1:
                break
            # the predicate sees the clean ids, never the prefix
            retry = {t for t, rr in clean.items() if retry_if(rr)}
            rows = [g for t, g in cur.trajectory_groups() if t in retry and g.size]
            if not rows:
                break
            cur = cur.subset(np.concatenate(rows))
        trace.escalation.add(recovered=sum(not retry_if(rr) for rr in last.values()))

    for ds, res in _fit_lsq_stream(
        datasets, ephem, params0, cfg0, seed, ut1, error_model, device=device, draws=draws, **stream_kw,
    ):
        held.append((ds, res, failed_tids(res)))
        if len(held) >= max(flush_every, 1):
            yield from flush()
    yield from flush()


def fit_lsq_stream_escalating(
    datasets,
    ephem,
    stages,
    seed: int = 0,
    ut1: Optional[Ut1Provider] = None,
    error_model: Optional[ErrorModel] = None,
    retry_if=None,
    flush_every: int = 4,
    refit_fill: int = 8,
    device=None,
    **stream_kw,
):
    """Tiered fitting over a stream: the lean stage (``stages[0]``) streams
    every dataset through :func:`fit_lsq_stream` (``stream_kw``: ``depth``
    and ``prefetch``, which have no effect there, ``slim_fetch``,
    ``as_table`` (default True here), ``minimal_fetch``), and the trajectories that fail it are refitted with
    the richer stages in batched passes spanning up to ``flush_every``
    datasets' failures.  Yields ``(dataset, results)`` in input order, the
    failed rows patched before their dataset is yielded.

    Escalated rows draw their noise under the id ``"<k>|<tid>"`` (k = the
    dataset's position in the held buffer), so a fixed stream is
    reproducible, but an escalated row's realization differs from a
    standalone :func:`fit_lsq_escalating` run.

    ``refit_fill`` is accepted and has no effect: the JAX package tops each
    refit up with discarded filler rows to pin XLA's compile shapes, and the
    port compiles nothing per shape, so it fits the failures alone (a real
    row's result does not depend on its batchmates either way).  The
    parameters are the JAX package's, in its order, with ``device`` in
    place of ``mesh``, after ``refit_fill``.
    """
    return _fit_lsq_stream_escalating(
        datasets, ephem, stages, seed, ut1, error_model, retry_if, flush_every, device, **stream_kw,
    )
