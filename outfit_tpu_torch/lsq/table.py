# Source: outfit_tpu/lsq/table.py (copied; imports retargeted to this package;
# rows materialize in one pass, _rows, which keeps a stored ok=False, see there).
"""Columnar result container for survey-scale fused fits.

The dict-of-``LsqResult`` API (parity: ``FullOrbitResult``,
constants.rs:195) constructs one Python object per trajectory — measured
at 5-15 us/row, i.e. 80-250 ms per 16384-trajectory dataset, a
GIL-bound cost that contends with the stream's dispatch thread.  At
survey scale (fink-fat runs are 1e5+ trajectories) consumers want
columns anyway (parquet/arrow/dataframes), so ``as_table=True`` on the
fused entry points skips row construction entirely and returns this
container: pure vectorized numpy assembly (~1 ms/dataset), with
per-row ``LsqResult``/``FitResult`` objects (and their error strings)
materialized lazily only on access.

All columns are length ``len(traj_ids)`` in DATASET trajectory order
(``ObsDataset.traj_ids``), with inert fill (NaN / -1 / False) for rows
that never reached a given stage.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["LsqTable"]

#: IOD per-row error classification codes (strings built lazily)
IOD_OK = 0
IOD_NO_VIABLE_ORBIT = 1
IOD_NO_FEASIBLE_TRIPLETS = 2
IOD_HOST_SCREENED = 3  # string recorded in ``host_errors``
IOD_SEED_NOT_FINITE = 4


@dataclass(slots=True)
class LsqTable:
    """Columnar fused IOD+LSQ results (one row per dataset trajectory)."""

    #: dataset trajectory ids, row order of every column
    traj_ids: List[str]
    #: row ran the fused LSQ kernel (an IOD seed existed and was finite)
    kept: np.ndarray
    # --- IOD columns (parity: FitResult fields) ---
    iod_ok: np.ndarray
    iod_error_code: np.ndarray  # int8, IOD_* codes above
    iod_rms: np.ndarray
    iod_kind: np.ndarray  # int8; -1 absent, 0 kepl, 1 equin, 2 cometary
    iod_corrected: np.ndarray
    iod_epoch: np.ndarray  # MJD (TT), light-time corrected
    iod_elements: np.ndarray  # (N, 6) native-kind display elements
    iod_equinoctial: np.ndarray  # (N, 6) ecliptic J2000
    # --- LSQ columns (parity: LsqResult fields) ---
    ok: np.ndarray  #: fit produced usable elements (converged OR fallback)
    converged: np.ndarray  #: converged through the least-squares loop
    fell_back_to_iod: np.ndarray
    #: int8 LSQ kernel status code (lsq/loop.py convention, the one the
    #: device path stores): 1 = converged (STATUS_OK), 2 = bizarre orbit,
    #: 3 = diverged, 4 = inversion failed, -1 = LSQ never ran
    status: np.ndarray
    normalised_rms: np.ndarray  # IOD rms on fallback rows (dict parity)
    epoch: np.ndarray
    equinoctial: np.ndarray  # (N, 6); IOD seed on fallback rows
    covariance_tri: np.ndarray  # (N, 21) lower triangle; NaN where absent
    uncertainties: np.ndarray  # (N, 6) 1-sigma; NaN where absent
    n_active_obs: np.ndarray  # int32
    total_newton_iterations: np.ndarray  # int32
    # --- lazy error-string ingredients ---
    host_errors: Dict[str, str] = field(default_factory=dict)
    _lane_counts: Optional[np.ndarray] = None
    _arc: Optional[np.ndarray] = None
    _counts: Optional[np.ndarray] = None
    _dt_min: float = 0.0
    _dt_max: float = 0.0
    _ktrips: Optional[np.ndarray] = None
    #: lazily built {traj_id: row} map (_row_index); never set directly
    _tid_index: Optional[Dict[str, int]] = field(
        default=None, repr=False, compare=False
    )

    def __len__(self) -> int:
        return len(self.traj_ids)

    @property
    def covariance(self) -> np.ndarray:
        """Full symmetric (N, 6, 6) covariance (NaN rows where absent)."""
        from outfit_tpu_torch.lsq.api import _unpack_cov

        return _unpack_cov(self.covariance_tri)

    # -- lazy per-row views -------------------------------------------------

    def _row_index(self, traj_id) -> int:
        # O(1) via a lazily built id->row map: ``traj_ids`` is immutable
        # after construction (patch_row rewrites row VALUES, never ids),
        # so a per-lookup list.index would make any "for tid in
        # table.traj_ids: table.result(tid)" migration loop O(T^2) at
        # survey scale
        if self._tid_index is None:
            object.__setattr__(
                self, "_tid_index",
                {t: i for i, t in enumerate(self.traj_ids)},
            )
        try:
            return self._tid_index[traj_id]
        except KeyError:
            raise KeyError(traj_id) from None

    def iod_error(self, i: int) -> Optional[str]:
        """Error string for row ``i``'s IOD stage (None when it succeeded).

        Matches the strings the dict API stores (NoViableOrbit /
        NoFeasibleTriplets / host-screen messages)."""
        code = int(self.iod_error_code[i])
        if code == IOD_OK:
            return None
        if code == IOD_HOST_SCREENED:
            return self.host_errors.get(self.traj_ids[i], "no IOD seed")
        from outfit_tpu_torch.errors import NoFeasibleTriplets, NoViableOrbit

        if code == IOD_NO_FEASIBLE_TRIPLETS:
            return str(
                NoFeasibleTriplets(
                    float(self._arc[i]), int(self._counts[i]),
                    self._dt_min, self._dt_max,
                )
            )
        if code == IOD_SEED_NOT_FINITE:
            return "IOD seed not finite"
        return str(NoViableOrbit(int(self._lane_counts[i])))

    def iod_result(self, traj_id):
        """Materialize the IOD stage of one row as a ``FitResult``."""
        return self._iod_rows(np.array([self._row_index(traj_id)]))[0]

    def _iod_rows(self, idx):
        """The IOD stage of rows ``idx`` as ``FitResult`` objects."""
        from outfit_tpu_torch.iod.api import _fit_results

        cols = (self.iod_ok, self.iod_rms, self.iod_corrected, self.iod_epoch, self.iod_kind, self.iod_elements,
                self.iod_equinoctial)
        return _fit_results([self.traj_ids[i] for i in idx.tolist()], idx, cols, self.iod_error)

    def result(self, traj_id):
        """Materialize one row as the ``LsqResult`` the dict API returns."""
        return self._rows(np.array([self._row_index(traj_id)]))[0]

    def _rows(self, idx=None, iods=None):
        """Rows ``idx`` (default: every row) as ``LsqResult`` objects, in one
        pass that reads each column once.  ``iods``: the rows' ``LsqResult.iod``
        objects (a seeded fit's own ``FitResult``, None where the caller gave
        no seed), default the IOD columns materialized."""
        from outfit_tpu_torch.lsq.api import LsqResult, _status_name, _unpack_cov

        idx = np.arange(len(self)) if idx is None else np.asarray(idx, np.int64)
        if iods is None:
            iods = self._iod_rows(idx)
        cols = (self.ok, self.kept, self.iod_ok, self.iod_error_code, self.converged, self.status,
                self.normalised_rms, self.epoch, self.n_active_obs, self.total_newton_iterations)
        ok, kept, iod_ok, code, conv, status, rms, epoch, n_act, its = (c[idx].tolist() for c in cols)
        tids, eq, sig = self.traj_ids, self.equinoctial, self.uncertainties
        cov = list(_unpack_cov(self.covariance_tri[idx]))
        out = []
        for j, (i, iod) in enumerate(zip(idx.tolist(), iods)):
            tid = tids[i]
            # trust the stored ok flag before inferring from the IOD columns:
            # hand-built results (from_results with r.iod=None) have no IOD
            # stage, and inferring "IOD failed" from its absence would flip
            # their ok=True on round trip
            if not ok[j] and (not kept[j] or not iod_ok[j]):
                err = iod.error if iod is not None else "no IOD seed"
                r = LsqResult(tid, ok=False, error=f"IOD failed: {err}", iod=iod)
            elif code[j] == IOD_SEED_NOT_FINITE:
                r = LsqResult(tid, ok=False, error="IOD seed not finite", iod=iod)
            elif not ok[j]:
                # the stored flag holds for a kept row with a good IOD too
                # (the JAX table returns such a hand-built row as ok=True);
                # its error text is in ``host_errors`` (_fill_row, lsq.api._seed_table)
                r = LsqResult(tid, ok=False, error=self.host_errors.get(tid), iod=iod)
            elif conv[j]:
                r = LsqResult(tid, ok=True, status=status[j], normalised_rms=rms[j], epoch=epoch[j],
                              equinoctial=eq[i], covariance=cov[j], uncertainties=sig[i],
                              n_active_obs=n_act[j], total_newton_iterations=its[j], iod=iod)
            else:
                r = LsqResult(tid, ok=True, error=_status_name(status[j]), status=status[j], fell_back_to_iod=True,
                              normalised_rms=rms[j], epoch=epoch[j], equinoctial=np.array(eq[i]),
                              n_active_obs=n_act[j], iod=iod)
            out.append(r)
        return out

    __getitem__ = result

    def to_results(self) -> Dict[str, object]:
        """Materialize the full per-trajectory dict (identical to the
        ``as_table=False`` return; used for parity tests and migration)."""
        return {r.traj_id: r for r in self._rows()}

    def to_dataframe(self):
        """Flat pandas DataFrame, one row per trajectory: scalar columns
        verbatim, vector columns expanded (``equinoctial_0..5``,
        ``sigma_0..5``, ``cov_00..cov_55`` lower triangle, IOD seed
        columns).  The survey-scale hand-off format (the reference's
        consumers feed polars/parquet pipelines, SURVEY 2.12)."""
        import pandas as pd

        data = {
            "traj_id": self.traj_ids,
            "ok": self.ok,
            "converged": self.converged,
            "fell_back_to_iod": self.fell_back_to_iod,
            "status": self.status,
            "normalised_rms": self.normalised_rms,
            "epoch": self.epoch,
            "n_active_obs": self.n_active_obs,
            "total_newton_iterations": self.total_newton_iterations,
            "iod_ok": self.iod_ok,
            "iod_error_code": self.iod_error_code,
            "iod_rms": self.iod_rms,
            "iod_kind": self.iod_kind,
            "iod_corrected": self.iod_corrected,
            "iod_epoch": self.iod_epoch,
        }
        names = ("a", "h", "k", "p", "q", "lambda")
        for j, nm in enumerate(names):
            data[f"eq_{nm}"] = self.equinoctial[:, j]
        for j, nm in enumerate(names):
            data[f"sigma_{nm}"] = self.uncertainties[:, j]
        for j, nm in enumerate(names):
            data[f"iod_eq_{nm}"] = self.iod_equinoctial[:, j]
        tri_i, tri_j = np.tril_indices(6)
        for s, (r, c) in enumerate(zip(tri_i, tri_j)):
            data[f"cov_{r}{c}"] = self.covariance_tri[:, s]
        return pd.DataFrame(data)

    def to_parquet(self, path, **kwargs):
        """Write :meth:`to_dataframe` to parquet (needs pyarrow or
        fastparquet installed)."""
        self.to_dataframe().to_parquet(path, **kwargs)

    @classmethod
    def from_results(cls, traj_ids, results) -> "LsqTable":
        """Build a table from a ``{traj_id: LsqResult}`` dict (the
        degenerate host-resolved path — per-row cost is fine there)."""
        tids = list(traj_ids)
        t = cls(tids, **_blank_columns(len(tids)))
        for i, tid in enumerate(tids):
            r = results.get(tid)
            if r is None:
                continue
            t._fill_row(i, tid, r)
        return t

    def patch_row(self, traj_id, r) -> None:
        """Overwrite one row from an ``LsqResult`` (``table[traj_id] = r``):
        every column, the IOD ones and ``kept`` included, so that no stale
        value of an earlier stage stays in the row."""
        self._set_rows([self._row_index(traj_id)], LsqTable.from_results([traj_id], {traj_id: r}), [0])

    __setitem__ = patch_row

    def _set_rows(self, rows, src, src_rows) -> None:
        """Rows ``rows`` overwritten by the table ``src``'s rows ``src_rows``,
        every column and each row's ``host_errors`` entry (the escalation
        copies a richer stage's rows back this way)."""
        for name in _COLUMNS:
            getattr(self, name)[rows] = getattr(src, name)[src_rows]
        for i, j in zip(np.asarray(rows).tolist(), np.asarray(src_rows).tolist()):
            tid, text = self.traj_ids[i], src.host_errors.get(src.traj_ids[j])
            self.host_errors.pop(tid, None)
            if text is not None:
                self.host_errors[tid] = text

    def _fill_row(self, i, tid, r) -> None:
        """Populate row ``i`` from an ``LsqResult`` (shared by
        ``from_results`` and ``patch_row``)."""
        t = self
        iod = r.iod
        if iod is not None:
            t.iod_ok[i] = iod.ok
            if iod.ok:
                t.iod_error_code[i] = IOD_OK
                t.iod_rms[i] = iod.rms
                t.iod_kind[i] = iod.kind
                t.iod_corrected[i] = iod.corrected
                t.iod_epoch[i] = iod.epoch
                t.iod_elements[i] = iod.elements
                t.iod_equinoctial[i] = iod.equinoctial
            elif iod.error:
                t.host_errors[tid] = iod.error
            if iod.ok and not r.ok and r.error:
                # unused by iod_error (the IOD code is IOD_OK): the row's
                # own error text, for result()
                t.host_errors[tid] = r.error
        t.kept[i] = r.equinoctial is not None or (
            iod is not None and iod.ok
        )
        t.ok[i] = r.ok
        t.converged[i] = r.ok and not r.fell_back_to_iod and (
            r.covariance is not None
        )
        t.fell_back_to_iod[i] = r.fell_back_to_iod
        if r.ok and r.equinoctial is not None:
            # kernel status-code convention (see the ``status`` field
            # doc): LsqResult carries the numeric code directly; the
            # error-string reverse-map remains only for hand-built
            # results predating the ``status`` field (drifted strings
            # there would otherwise mislabel rows as DIVERGED)
            if getattr(r, "status", -1) >= 0:
                t.status[i] = r.status
            elif t.converged[i]:
                t.status[i] = 1
            else:
                from outfit_tpu_torch.lsq.api import _STATUS_NAMES

                t.status[i] = next(
                    (
                        c
                        for c, name in _STATUS_NAMES.items()
                        if name is not None and name == r.error
                    ),
                    3,
                )
            t.normalised_rms[i] = r.normalised_rms
            t.epoch[i] = r.epoch
            t.equinoctial[i] = r.equinoctial
            t.n_active_obs[i] = r.n_active_obs
            t.total_newton_iterations[i] = r.total_newton_iterations
            if r.covariance is not None:
                t.covariance_tri[i] = np.asarray(r.covariance)[
                    _TRIL_I_IDX, _TRIL_J_IDX
                ]
            if r.uncertainties is not None:
                t.uncertainties[i] = r.uncertainties


def _blank_columns(n):
    """Every column of an ``n``-row table at its inert fill (NaN / -1 /
    False, an IOD stage that never ran)."""
    return dict(
        kept=np.zeros(n, bool),
        iod_ok=np.zeros(n, bool),
        iod_error_code=np.full(n, IOD_HOST_SCREENED, np.int8),
        iod_rms=np.full(n, np.nan),
        iod_kind=np.full(n, -1, np.int8),
        iod_corrected=np.zeros(n, bool),
        iod_epoch=np.full(n, np.nan),
        iod_elements=np.full((n, 6), np.nan),
        iod_equinoctial=np.full((n, 6), np.nan),
        ok=np.zeros(n, bool),
        converged=np.zeros(n, bool),
        fell_back_to_iod=np.zeros(n, bool),
        status=np.full(n, -1, np.int8),
        normalised_rms=np.full(n, np.nan),
        epoch=np.full(n, np.nan),
        equinoctial=np.full((n, 6), np.nan),
        covariance_tri=np.full((n, 21), np.nan),
        uncertainties=np.full((n, 6), np.nan),
        n_active_obs=np.zeros(n, np.int32),
        total_newton_iterations=np.zeros(n, np.int32),
    )


#: the per-row columns, in field order
_COLUMNS = tuple(_blank_columns(0))

#: lower-triangle index pair for covariance packing (built once)
_TRIL_I_IDX, _TRIL_J_IDX = np.tril_indices(6)
