# Source: outfit_tpu/observations/dataset.py (copied; imports retargeted to this package).
"""ObsDataset: the observation container consumed by the fitting pipeline.

Ingestion from MPC 80-column files (native C parser or Python), ADES XML,
dataframes and parquet; per-observation star-catalog biases; error models
and the batch RMS correction.  Struct-of-arrays (numpy, host-side) with
integer indices into trajectory-id and observer tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from outfit_tpu_torch.observations.error_model import ErrorModel, batch_rms_correction
from outfit_tpu_torch.observations.mpc80 import MpcRecord, parse_file
from outfit_tpu_torch.observations.observatories import Observer, get_observatory


@dataclass
class Observation:
    """Single-observation view."""

    index: int
    traj_id: str
    mjd_tt: float
    ra: float
    dec: float
    ra_error: float
    dec_error: float
    observer: Observer


@dataclass
class ObsDataset:
    mjd_tt: np.ndarray = field(default_factory=lambda: np.empty(0))
    ra: np.ndarray = field(default_factory=lambda: np.empty(0))
    dec: np.ndarray = field(default_factory=lambda: np.empty(0))
    ra_error: np.ndarray = field(default_factory=lambda: np.empty(0))  # radians
    dec_error: np.ndarray = field(default_factory=lambda: np.empty(0))
    traj_index: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.int64))
    observer_index: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.int64))
    traj_ids: List[str] = field(default_factory=list)
    observers: List[Observer] = field(default_factory=list)
    mag: np.ndarray = field(default_factory=lambda: np.empty(0))
    #: per-observation astrometric reference catalog code (MPC col 72)
    catalog: np.ndarray = field(default_factory=lambda: np.empty(0, dtype="U1"))
    #: optional per-observation astrometric bias (radians), e.g. star-catalog
    #: debiasing, subtracted from the residuals by the correction
    bias_ra: Optional[np.ndarray] = None
    bias_dec: Optional[np.ndarray] = None

    def set_bias(self, bias_ra, bias_dec) -> "ObsDataset":
        """Attach per-observation astrometric biases (radians)."""
        bias_ra = np.asarray(bias_ra, np.float64)
        bias_dec = np.asarray(bias_dec, np.float64)
        if bias_ra.shape != self.mjd_tt.shape or bias_dec.shape != self.mjd_tt.shape:
            raise ValueError("bias arrays must match the observation count")
        self.bias_ra = bias_ra
        self.bias_dec = bias_dec
        return self

    def apply_debias(self, table=None) -> "ObsDataset":
        """Attach star-catalog debiasing biases for every observation from
        a published Eggl et al. (2020) table (see
        :mod:`outfit_tpu_torch.observations.debias`); ``table=None`` loads
        the file ``$OUTFIT_DEBIAS`` points at.  The correction subtracts the
        biases from the residuals."""
        from outfit_tpu_torch.observations.debias import DebiasTable

        if table is None:
            table = DebiasTable.load()
        return table.apply(self)

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_records(cls, records: Sequence[MpcRecord]) -> "ObsDataset":
        return cls._build(records)

    @staticmethod
    def _canonical_file_tid(first_id: str) -> str:
        """Canonical per-file trajectory id: the packed number (sans leading
        zeros) or the first provisional designation."""
        tid = str(first_id).strip()
        return str(int(tid)) if tid.isdigit() else tid

    @classmethod
    def from_mpc_80_col_files(
        cls,
        paths: Iterable[str],
        native: bool = True,
        trajectory_per_file: bool = True,
    ) -> "ObsDataset":
        """Parse MPC 80-col files, with the native C parser when ``native``
        and a C compiler are there
        (:func:`~outfit_tpu_torch.observations.native.native_available`),
        else with the Python parser; the two give the same dataset.
        ``trajectory_per_file=True`` makes every record of a file one
        trajectory named after the file's first record (e.g. ``2015AB.obs``
        is K09R05F recovered as K15A00B: one trajectory keyed "K09R05F")."""
        paths = list(paths)  # may be a one-shot iterator
        if native:
            from outfit_tpu_torch.observations.native import native_available, parse_file_native

            if native_available():
                return cls._build_from_native([parse_file_native(p) for p in paths], trajectory_per_file)
        records: List[MpcRecord] = []
        for p in paths:
            recs = parse_file(p)
            if trajectory_per_file and recs:
                tid = cls._canonical_file_tid(recs[0].traj_id)
                recs = [r._replace_traj(tid) for r in recs]
            records.extend(recs)
        return cls._build(records)

    @classmethod
    def _build_from_native(cls, parsed_files, trajectory_per_file: bool = True) -> "ObsDataset":
        ds = cls()
        traj_map: Dict[str, int] = {}
        obs_map: Dict[str, int] = {}
        chunks = {k: [] for k in ("mjd", "ra", "dec", "mag", "ti", "oi", "cat")}
        for mjd, ra, dec, mag, ids, codes, _disc, cats in parsed_files:
            if trajectory_per_file and len(ids):
                ids = [cls._canonical_file_tid(ids[0])] * len(ids)
            chunks["mjd"].append(mjd)
            chunks["ra"].append(ra)
            chunks["dec"].append(dec)
            chunks["mag"].append(mag)
            chunks["cat"].append(cats)
            ti = np.empty(len(ids), dtype=np.int64)
            oi = np.empty(len(ids), dtype=np.int64)
            for i, (tid, code) in enumerate(zip(ids, codes)):
                t = traj_map.setdefault(tid, len(traj_map))
                if t == len(ds.traj_ids):
                    ds.traj_ids.append(str(tid))
                o = obs_map.setdefault(code, len(obs_map))
                if o == len(ds.observers):
                    ds.observers.append(get_observatory(str(code)))
                ti[i] = t
                oi[i] = o
            chunks["ti"].append(ti)
            chunks["oi"].append(oi)
        ds.mjd_tt = np.concatenate(chunks["mjd"]) if chunks["mjd"] else np.empty(0)
        ds.ra = np.concatenate(chunks["ra"]) if chunks["ra"] else np.empty(0)
        ds.dec = np.concatenate(chunks["dec"]) if chunks["dec"] else np.empty(0)
        ds.mag = np.concatenate(chunks["mag"]) if chunks["mag"] else np.empty(0)
        ds.catalog = np.concatenate(chunks["cat"]) if chunks["cat"] else np.empty(0, dtype="U1")
        ds.traj_index = np.concatenate(chunks["ti"]) if chunks["ti"] else np.empty(0, np.int64)
        ds.observer_index = np.concatenate(chunks["oi"]) if chunks["oi"] else np.empty(0, np.int64)
        n = len(ds.mjd_tt)
        ds.ra_error = np.full(n, np.nan)
        ds.dec_error = np.full(n, np.nan)
        return ds

    @classmethod
    def from_mpc_80_col(cls, path: str, trajectory_per_file: bool = True) -> "ObsDataset":
        return cls.from_mpc_80_col_files([path], trajectory_per_file=trajectory_per_file)

    @classmethod
    def from_ades(cls, path: str) -> "ObsDataset":
        """ADES XML ingestion; per-record rmsRA/rmsDec (when present) become
        the observation sigmas, others stay NaN for the error model."""
        from outfit_tpu_torch.observations.ades import read_ades

        records, sig = read_ades(path)
        ds = cls._build(records)
        for i, (sra, sdec) in enumerate(sig[: len(ds)]):
            if not np.isnan(sra):
                ds.ra_error[i] = sra
            if not np.isnan(sdec):
                ds.dec_error[i] = sdec
        return ds

    @classmethod
    def from_parquet(cls, path: str, **kwargs) -> "ObsDataset":
        """Parquet ingestion (pandas, imported here); column names via the
        :meth:`from_dataframe` keyword arguments."""
        import pandas as pd

        return cls.from_dataframe(pd.read_parquet(path), **kwargs)

    @classmethod
    def from_dataframe(cls, df, *, traj_col="trajectory_id", mjd_col="mjd_tt",
                       ra_col="ra", dec_col="dec", obs_col="observatory",
                       catalog_col="catalog", angles_in_degrees=True) -> "ObsDataset":
        """Columnar ingestion (a pandas or pyarrow-backed frame): columns
        become the dataset arrays directly, no per-row Python objects;
        trajectories and observers are numbered in order of first
        appearance."""
        import math

        scale = math.pi / 180.0 if angles_in_degrees else 1.0
        n = len(df)
        ds = cls()
        ds.mjd_tt = np.asarray(df[mjd_col], np.float64)
        ds.ra = np.asarray(df[ra_col], np.float64) * scale
        ds.dec = np.asarray(df[dec_col], np.float64) * scale
        ds.ra_error = np.full(n, np.nan)
        ds.dec_error = np.full(n, np.nan)
        ds.mag = np.full(n, np.nan)
        if catalog_col in df:
            raw = np.asarray(df[catalog_col], dtype=object)
            # nullable columns: NaN/None become the blank code, not
            # str(nan)[:1] == 'n' (a real MPC catalog code)
            missing = np.array([v is None or (isinstance(v, float) and math.isnan(v)) for v in raw])
            ds.catalog = np.where(missing, " ", raw.astype(str)).astype("U1")
            ds.catalog[ds.catalog == ""] = " "
        else:
            ds.catalog = np.full(n, " ", dtype="U1")

        tids = np.asarray(df[traj_col]).astype(str)
        ds.traj_ids, ds.traj_index = _first_appearance(tids, n)
        codes = np.asarray(df[obs_col]).astype(str) if obs_col in df else np.full(n, "500")
        uniq_o, ds.observer_index = _first_appearance(codes, n)
        ds.observers = [get_observatory(c) for c in uniq_o]
        return ds

    @classmethod
    def _build(cls, records: Sequence[MpcRecord]) -> "ObsDataset":
        ds = cls()
        traj_map: Dict[str, int] = {}
        obs_map: Dict[str, int] = {}
        n = len(records)
        ds.mjd_tt = np.empty(n)
        ds.ra = np.empty(n)
        ds.dec = np.empty(n)
        ds.ra_error = np.full(n, np.nan)
        ds.dec_error = np.full(n, np.nan)
        ds.traj_index = np.empty(n, dtype=np.int64)
        ds.observer_index = np.empty(n, dtype=np.int64)
        ds.mag = np.full(n, np.nan)
        ds.catalog = np.full(n, " ", dtype="U1")
        for i, r in enumerate(records):
            ti = traj_map.setdefault(r.traj_id, len(traj_map))
            if ti == len(ds.traj_ids):
                ds.traj_ids.append(r.traj_id)
            oi = obs_map.setdefault(r.observatory, len(obs_map))
            if oi == len(ds.observers):
                ds.observers.append(get_observatory(r.observatory))
            ds.mjd_tt[i] = r.mjd_tt
            ds.ra[i] = r.ra
            ds.dec[i] = r.dec
            ds.traj_index[i] = ti
            ds.observer_index[i] = oi
            if r.mag is not None:
                ds.mag[i] = r.mag
            ds.catalog[i] = getattr(r, "catalog", " ") or " "
        return ds

    def push_observation(
        self, traj_id: str, mjd_tt: float, ra: float, dec: float,
        ra_error: float, dec_error: float, observer: Observer,
        catalog: str = " ",
    ) -> None:
        """Append one observation (angles/sigmas in radians)."""
        if traj_id in self.traj_ids:
            ti = self.traj_ids.index(traj_id)
        else:
            ti = len(self.traj_ids)
            self.traj_ids.append(traj_id)
        key = observer.code or observer.name or f"obs{len(self.observers)}"
        oi = None
        for j, ob in enumerate(self.observers):
            if (ob.code or ob.name) == key and ob == observer:
                oi = j
                break
        if oi is None:
            oi = len(self.observers)
            self.observers.append(observer)
        self.mjd_tt = np.append(self.mjd_tt, mjd_tt)
        self.ra = np.append(self.ra, ra)
        self.dec = np.append(self.dec, dec)
        self.ra_error = np.append(self.ra_error, ra_error)
        self.dec_error = np.append(self.dec_error, dec_error)
        self.traj_index = np.append(self.traj_index, ti)
        self.observer_index = np.append(self.observer_index, oi)
        self.mag = np.append(self.mag, np.nan)
        self.catalog = np.append(self.catalog, catalog or " ")
        if self.bias_ra is not None:
            self.bias_ra = np.append(self.bias_ra, 0.0)
            self.bias_dec = np.append(self.bias_dec, 0.0)

    def subset(self, indices) -> "ObsDataset":
        """New dataset holding only the given observation rows (all columns,
        catalog codes and biases included)."""
        idx = np.asarray(indices, dtype=np.int64)
        kept_traj, traj_index = np.unique(self.traj_index[idx], return_inverse=True)
        return ObsDataset(
            mjd_tt=self.mjd_tt[idx].copy(),
            ra=self.ra[idx].copy(),
            dec=self.dec[idx].copy(),
            ra_error=self.ra_error[idx].copy(),
            dec_error=self.dec_error[idx].copy(),
            traj_index=traj_index.astype(np.int64, copy=False),
            observer_index=self.observer_index[idx].copy(),
            traj_ids=[self.traj_ids[t] for t in kept_traj.tolist()],
            observers=list(self.observers),
            mag=self.mag[idx].copy() if len(self.mag) == len(self) else self.mag,
            catalog=self.catalog[idx].copy() if len(self.catalog) == len(self) else self.catalog,
            bias_ra=None if self.bias_ra is None else self.bias_ra[idx].copy(),
            bias_dec=None if self.bias_dec is None else self.bias_dec[idx].copy(),
        )

    # -- error models ---------------------------------------------------------

    def apply_error_model(self, model: ErrorModel) -> "ObsDataset":
        """Assign per-observation sigmas.  Mutates and returns self."""
        codes = [self.observers[i].code or "?" for i in self.observer_index]
        cats = self.catalog if len(self.catalog) == len(self) else None
        sig = model.sigma_rad(codes, cats, mjd=self.mjd_tt)
        self.ra_error = sig.copy()
        self.dec_error = sig.copy()
        return self

    # the two names of the same operation in the JAX package's API
    with_error_model = apply_error_model
    apply_model_errors = apply_error_model

    def apply_batch_rms_correction(self, gap_max_days: float) -> "ObsDataset":
        """sqrt-N batch inflation within (trajectory, station) groups."""
        self.ra_error = batch_rms_correction(
            self.mjd_tt, self.traj_index, self.observer_index, self.ra_error, gap_max_days
        )
        self.dec_error = batch_rms_correction(
            self.mjd_tt, self.traj_index, self.observer_index, self.dec_error, gap_max_days
        )
        return self

    # -- access ---------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.mjd_tt)

    @property
    def n_trajectories(self) -> int:
        return len(self.traj_ids)

    def iter_traj_id(self):
        return iter(self.traj_ids)

    # one batched device pass is the parallel path, so the parallel iterator
    # is the sequential one
    par_iter_traj_id = iter_traj_id

    def _traj_row(self, traj_id: str) -> int:
        try:
            return self.traj_ids.index(traj_id)
        except ValueError:
            from outfit_tpu_torch.errors import TrajectoryIdNotFound

            raise TrajectoryIdNotFound(traj_id) from None

    def len_trajectory(self, traj_id: str) -> int:
        ti = self._traj_row(traj_id)
        return int(np.sum(self.traj_index == ti))

    def trajectory_obs_indices(self, traj_id: str) -> np.ndarray:
        """Observation indices of one trajectory, sorted by epoch."""
        ti = self._traj_row(traj_id)
        idx = np.nonzero(self.traj_index == ti)[0]
        return idx[np.argsort(self.mjd_tt[idx], kind="stable")]

    def trajectory_groups(self):
        """[(traj_id, epoch-sorted observation indices)] for every
        trajectory, in ``iter_traj_id`` order (one lexsort for the whole
        dataset)."""
        if len(self.mjd_tt) == 0:
            empty = np.empty(0, dtype=np.int64)
            return [(tid, empty) for tid in self.traj_ids]
        order = np.lexsort((self.mjd_tt, self.traj_index))
        ti_sorted = self.traj_index[order]
        bounds = np.nonzero(np.diff(ti_sorted))[0] + 1
        # each chunk keyed by its first member's trajectory (original index)
        groups = {int(self.traj_index[s[0]]): s for s in np.split(order, bounds)}
        empty = np.empty(0, dtype=np.int64)
        return [(tid, groups.get(ti, empty)) for ti, tid in enumerate(self.traj_ids)]

    def invalidate_caches(self) -> "ObsDataset":
        """Kept for the JAX package's API: its fit pipelines memoize device
        and layout tables on a dataset and need this after an in-place
        mutation; the port memoizes nothing on a dataset, so it only returns
        the dataset."""
        return self

    @classmethod
    def concat(cls, datasets, rename=None) -> "ObsDataset":
        """Concatenate datasets preserving every column (catalog codes,
        magnitudes, biases; zero bias for an input without).  ``rename(k,
        tid)`` maps the k-th input's trajectory id to the output id,
        required when the same id occurs in several inputs (the escalation
        path merging failures of a dataset stream); default keeps ids
        unchanged.  Identical observers are merged by value."""
        datasets = list(datasets)
        if not datasets:
            return cls()
        out = cls()
        n_obs = [len(d) for d in datasets]
        total = sum(n_obs)
        for f in ("mjd_tt", "ra", "dec", "ra_error", "dec_error"):
            setattr(out, f, np.concatenate([getattr(d, f) for d in datasets]))
        # optional per-observation columns: kept only if every input has
        # them aligned (a half-populated column would misalign the rest)
        if all(len(d.mag) == n for d, n in zip(datasets, n_obs)):
            out.mag = np.concatenate([d.mag for d in datasets])
        if all(len(d.catalog) == n for d, n in zip(datasets, n_obs)):
            out.catalog = np.concatenate([d.catalog for d in datasets])
        if any(d.bias_ra is not None for d in datasets):
            out.bias_ra = np.concatenate(
                [d.bias_ra if d.bias_ra is not None else np.zeros(n) for d, n in zip(datasets, n_obs)]
            )
            out.bias_dec = np.concatenate(
                [d.bias_dec if d.bias_dec is not None else np.zeros(n) for d, n in zip(datasets, n_obs)]
            )
        tidx, oidx = [], []
        obs_seen: dict = {}  # Observer (frozen dataclass) -> merged index
        for k, d in enumerate(datasets):
            t_off = len(out.traj_ids)
            out.traj_ids.extend(tid if rename is None else rename(k, tid) for tid in d.traj_ids)
            remap = np.empty(len(d.observers), np.int64)
            for j, o in enumerate(d.observers):
                m = obs_seen.get(o)
                if m is None:
                    m = obs_seen[o] = len(out.observers)
                    out.observers.append(o)
                remap[j] = m
            tidx.append(d.traj_index + t_off)
            oidx.append(remap[np.asarray(d.observer_index, np.int64)])
        out.traj_index = np.concatenate(tidx)
        out.observer_index = np.concatenate(oidx)
        assert len(out) == total
        return out

    def compact_observers(self) -> "ObsDataset":
        """New dataset keeping only the referenced observers (order of first
        reference); ``subset``/``concat`` keep the full observer lists."""
        import dataclasses

        seen = {}
        new_index = np.empty(len(self.observer_index), np.int64)
        for j, oi in enumerate(np.asarray(self.observer_index, np.int64)):
            k = seen.get(int(oi))
            if k is None:
                k = seen[int(oi)] = len(seen)
            new_index[j] = k
        out = dataclasses.replace(self)
        out.observer_index = new_index
        out.observers = [self.observers[oi] for oi in seen]
        return out

    def get_observation(self, i: int) -> Observation:
        return Observation(
            index=i,
            traj_id=self.traj_ids[self.traj_index[i]],
            mjd_tt=float(self.mjd_tt[i]),
            ra=float(self.ra[i]),
            dec=float(self.dec[i]),
            ra_error=float(self.ra_error[i]),
            dec_error=float(self.dec_error[i]),
            observer=self.observers[self.observer_index[i]],
        )

    def get_observer(self, i: int) -> Observer:
        return self.observers[i]

    def iter_observer(self):
        return iter(self.observers)

    def iter_observations(self):
        """Iterate all observations in storage order."""
        return (self.get_observation(i) for i in range(len(self)))

    def materialize_trajectory(self, traj_id: str) -> List[Observation]:
        return [self.get_observation(int(i)) for i in self.trajectory_obs_indices(traj_id)]


def _first_appearance(values: np.ndarray, n: int):
    """(distinct values in order of first appearance, each row's rank in
    that list)."""
    uniq, inv = np.unique(values, return_inverse=True)
    first = np.full(len(uniq), n, np.int64)
    np.minimum.at(first, inv, np.arange(n))
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return [str(v) for v in uniq[order]], rank[inv]
