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
    _IodColumns,
    _padded_layout,
    device_bases,
    prepare_dataset,
)
from outfit_tpu_torch.iod.params import IODParams
from outfit_tpu_torch.lsq.config import DifferentialCorrectionConfig
from outfit_tpu_torch.lsq.iteration import SEL_ACTIVE, ObsArrays
from outfit_tpu_torch.lsq.loop import STATUS_OK, check_supported, differential_correction
from outfit_tpu_torch.lsq.table import IOD_OK, LsqTable, _blank_columns
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


@dataclasses.dataclass(slots=True)
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


def _seed_table(seeds):
    """The fit's table, its IOD columns filled from ``seeds``
    (:class:`_IodColumns`), and the mask of the rows with a usable seed
    (ok, finite equinoctial elements), which the correction fills in.  A
    row without one keeps its error text, as ``LsqTable.from_results``
    keeps it."""
    ok = seeds.ok
    t = LsqTable(seeds.traj_ids, **_blank_columns(len(ok)))
    t.kept[ok] = t.iod_ok[ok] = True
    t.iod_error_code[ok] = IOD_OK
    for name in ("rms", "kind", "corrected", "epoch", "elements", "equinoctial"):
        getattr(t, "iod_" + name)[ok] = getattr(seeds, name)[ok]
    usable = ok & np.isfinite(seeds.equinoctial).all(axis=1)
    for i in np.nonzero(~usable)[0].tolist():
        tid, text = t.traj_ids[i], seeds.errors.get(i)
        if ok[i]:  # the IOD stage stands; the row's own error text
            t.host_errors[tid] = f"IOD failed: {text}" if i in seeds.errors else "IOD seed not finite"
        elif text:
            t.host_errors[tid] = text
    return t, usable


def _correct(layout, rsel, el0, ep0, config, base, device, slim=False, ephem=None):
    """Differential correction of the dataset rows ``rsel`` from the seed
    elements ``el0`` (T, 6) at epochs ``ep0`` on ``device``, every row at
    the dataset's padded width.  Returns the per-row host arrays (status,
    elements, RMS, covariance lower triangle, active observations,
    iterations) and the pre-warm's trip count.  ``slim``: the covariance
    crosses to the host as float32.  ``ephem``: for an N-body
    ``config.propagator`` (moved to ``device`` here)."""
    with trace.span("correct"):
        valid_all, glob_all = layout
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
    """The corrected rows written into the fit's table ``results`` from the
    :func:`_correct` outputs of their consecutive chunks ``parts``:
    ``rows`` names them as ``(traj_id, row)`` pairs, ``row_of`` holds their
    rows.  A row whose correction failed falls back to its seed orbit
    (diff_cor mod.rs:113), held in the IOD columns.  A row's iteration
    count holds its chunk's pre-warm trip count; one batch's would be the
    largest chunk's (its slowest row), and every row gets that."""
    prewarm = max(p for _, p in parts)
    status, elements, rms, cov_tri, n_active = (np.concatenate([a[k] for a, _ in parts]) for k in range(5))
    its = np.concatenate([a[5] + (prewarm - p) for a, p in parts])
    cov_tri = cov_tri.astype(np.float64, copy=False)
    sigmas = uncertainties_from_covariance(torch.from_numpy(_unpack_cov(cov_tri))).numpy()
    t, conv = results, (status == STATUS_OK) & np.isfinite(elements).all(axis=1)
    c, f = row_of[conv], row_of[~conv]
    t.ok[row_of], t.status[row_of], t.epoch[row_of] = True, status, t.iod_epoch[row_of]
    t.converged[c], t.normalised_rms[c], t.equinoctial[c] = True, rms[conv], elements[conv]
    t.covariance_tri[c], t.uncertainties[c] = cov_tri[conv], sigmas[conv]
    t.n_active_obs[c], t.total_newton_iterations[c] = n_active[conv], its[conv]
    t.fell_back_to_iod[f], t.normalised_rms[f], t.equinoctial[f] = True, t.iod_rms[f], t.iod_equinoctial[f]
    t.n_active_obs[f] = valid_all[f].sum(axis=1)


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
        iods = None
        if initial_orbits is None:
            seeds = _IodBatch(dataset, iod_params.validated(), seed, layout, devices, draws, slim).fit(devices, bases)
        with trace.span("fit.prepare"):
            if initial_orbits is not None:
                seeds, iods = _IodColumns.of(dataset.traj_ids, initial_orbits)
            table, usable = _seed_table(seeds)
            rsel = np.nonzero(usable)[0]
            rows = list(zip([dataset.traj_ids[i] for i in rsel.tolist()], rsel.tolist()))
        parts = []
        if rsel.size:

            def work(device, chunk):
                a, b = chunk
                if a == b:
                    return None
                r = rsel[a:b]
                return _correct(layout, r, seeds.equinoctial[r], seeds.epoch[r], config, bases(device), device, slim,
                                ephem)

            parts = map_devices(devices, work, chunk_bounds([(0, rsel.size)], len(devices)))
        with trace.span("fit.assemble"):
            if rsel.size:
                _add_results(table, rows, [p for p in parts if p is not None], layout[0], rsel)
            if minimal:
                # the JAX package's minimal_fetch contract
                table.iod_elements[table.converged] = np.nan
                table.iod_equinoctial[table.converged] = np.nan
            if as_table:
                return table
            if iods is None:
                return table.to_results()
            # a seeded fit: the rows without a usable seed first, as the
            # JAX package returns them, each with the caller's FitResult
            order = np.argsort(usable, kind="stable")
            return {r.traj_id: r for r in table._rows(order, [iods[i] for i in order.tolist()])}


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


@dataclasses.dataclass
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


def _retry(table, rows, retry_if):
    """Which of ``table``'s rows ``rows`` to refit: with no ``retry_if``,
    those whose converged flag is down (what :func:`_default_retry`
    retries); a user's ``retry_if`` sees each row's ``LsqResult``."""
    if retry_if is None:
        return ~table.converged[rows]
    return np.array([bool(retry_if(r)) for r in table._rows(rows)], bool)


def _failed_subset(dataset, fail):
    """The observations of ``dataset``'s trajectories where the row mask
    ``fail`` holds, trajectory by trajectory in dataset order, each sorted
    by epoch, and those trajectories' rows (one without observations drops
    out)."""
    idx = np.nonzero(fail[dataset.traj_index])[0]
    idx = idx[np.lexsort((dataset.mjd_tt[idx], dataset.traj_index[idx]))]
    return dataset.subset(idx), np.unique(dataset.traj_index[idx])


def _fit_lsq_escalating(dataset, ephem, stages, seed, ut1, error_model, retry_if, device, draws=None):
    if not stages:
        raise ValueError("fit_lsq_escalating needs at least one (params, config) stage")
    cur = dataset
    for k, (params, cfg) in enumerate(stages):
        tab = _fit_lsq(cur, ephem, params, cfg, seed, ut1, error_model, None, None, device, draws, as_table=True)
        if k == 0:
            table, at = tab, np.arange(len(tab))  # at: each row of ``cur``'s row in ``table``
        else:
            table._set_rows(at, tab, np.arange(len(tab)))
        if k == len(stages) - 1:
            break
        cur, rows = _failed_subset(cur, _retry(tab, np.arange(len(tab)), retry_if))
        if not rows.size:
            break
        at = at[rows]
    with trace.span("fit.assemble"):
        return table.to_results()


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
    for name in ("depth", "prefetch"):  # accepted, no effect (fit_lsq_stream)
        stream_kw.pop(name, None)
    stream_kw = dict(dict(as_table=True, slim_fetch=False, minimal_fetch=False), **stream_kw)
    as_table = stream_kw.pop("as_table")
    params0, cfg0 = stages[0]
    for _, cfg in stages[1:]:
        check_supported(cfg)
    held = []  # [(dataset, table, its rows to refit)]

    def retried(at):
        """The held rows ``at`` ((held index, row) pairs, by held index) that
        the predicate retries; it sees their clean ids, never the prefix."""
        return np.concatenate([_retry(held[h][1], at[at[:, 0] == h, 1], retry_if)
                               for h in np.unique(at[:, 0]).tolist()])

    def flush():
        """One batched pass per richer stage over the held datasets'
        failures, copied into their tables; yield the held datasets in
        order, each as a dict when asked for one."""
        if held:
            with trace.span("escalate"):
                refit()
        out = [(ds, tab) for ds, tab, _ in held]
        held.clear()
        if as_table:
            return out
        with trace.span("fit.assemble"):
            return [(ds, tab.to_results()) for ds, tab in out]

    def refit():
        parts, at = [], []
        for h, (ds, _tab, fail) in enumerate(held):
            sub, rows = _failed_subset(ds, fail)
            if rows.size:
                parts.append((h, sub))
                at.append(np.stack([np.full(rows.size, h), rows], axis=1))
        if not parts:
            trace.escalation.add(flushes=1)
            return
        # held-index-prefixed ids: the same id may occur in several held
        # datasets, and the prefix selects the escalated noise
        cur = ObsDataset.concat([sub for _, sub in parts], rename=lambda k, tid: f"{parts[k][0]}|{tid}")
        at = first = np.concatenate(at)  # each refit row's (held index, row)
        trace.escalation.add(flushes=1, rows=len(cur.traj_ids))
        for k, (p, c) in enumerate(stages[1:], start=1):
            tab = _fit_lsq(cur, ephem, p, c, seed, ut1, error_model, None, None, device, draws, as_table=True)
            for h in np.unique(at[:, 0]).tolist():
                m = at[:, 0] == h
                held[h][1]._set_rows(at[m, 1], tab, np.nonzero(m)[0])
            if k == len(stages) - 1:
                break
            cur, rows = _failed_subset(cur, retried(at))
            if not rows.size:
                break
            at = at[rows]
        trace.escalation.add(recovered=int((~retried(first)).sum()))

    _check_fetch_modes(as_table, stream_kw["minimal_fetch"])
    for ds, tab in _fit_lsq_stream(
        datasets, ephem, params0, cfg0, seed, ut1, error_model, device=device, draws=draws, as_table=True, **stream_kw,
    ):
        held.append((ds, tab, _retry(tab, np.arange(len(tab)), retry_if)))
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
