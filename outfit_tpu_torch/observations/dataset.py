# Source: outfit_tpu/observations/dataset.py (trimmed to MPC 80-column ingestion,
# push_observation, subset, concat, trajectory groups, error models and the
# batch RMS correction; no bias columns).
"""ObsDataset: the observation container consumed by the fitting pipeline.

Struct-of-arrays (numpy, host-side) with integer indices into
trajectory-id and observer tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence

import numpy as np

from outfit_tpu_torch.observations.error_model import ErrorModel, batch_rms_correction
from outfit_tpu_torch.observations.mpc80 import MpcRecord, parse_file
from outfit_tpu_torch.observations.observatories import Observer, get_observatory


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

    # -- construction ---------------------------------------------------------

    @staticmethod
    def _canonical_file_tid(first_id: str) -> str:
        """Canonical per-file trajectory id: the packed number (sans leading
        zeros) or the first provisional designation."""
        tid = str(first_id).strip()
        return str(int(tid)) if tid.isdigit() else tid

    @classmethod
    def from_mpc_80_col_files(
        cls, paths: Iterable[str], trajectory_per_file: bool = True
    ) -> "ObsDataset":
        """Parse MPC 80-col files.  ``trajectory_per_file=True`` makes every
        record of a file one trajectory named after the file's first record
        (e.g. ``2015AB.obs`` is K09R05F recovered as K15A00B: one
        trajectory keyed "K09R05F")."""
        records: List[MpcRecord] = []
        for p in paths:
            recs = parse_file(p)
            if trajectory_per_file and recs:
                tid = cls._canonical_file_tid(recs[0].traj_id)
                recs = [r._replace_traj(tid) for r in recs]
            records.extend(recs)
        return cls._build(records)

    @classmethod
    def from_mpc_80_col(cls, path: str, trajectory_per_file: bool = True) -> "ObsDataset":
        return cls.from_mpc_80_col_files([path], trajectory_per_file=trajectory_per_file)

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

    def subset(self, indices) -> "ObsDataset":
        """New dataset holding only the given observation rows (all columns)."""
        idx = np.asarray(indices, dtype=np.int64)
        kept_traj = sorted(set(int(t) for t in self.traj_index[idx]))
        tmap = {t: i for i, t in enumerate(kept_traj)}
        return ObsDataset(
            mjd_tt=self.mjd_tt[idx].copy(),
            ra=self.ra[idx].copy(),
            dec=self.dec[idx].copy(),
            ra_error=self.ra_error[idx].copy(),
            dec_error=self.dec_error[idx].copy(),
            traj_index=np.array([tmap[int(t)] for t in self.traj_index[idx]], dtype=np.int64),
            observer_index=self.observer_index[idx].copy(),
            traj_ids=[self.traj_ids[t] for t in kept_traj],
            observers=list(self.observers),
            mag=self.mag[idx].copy() if len(self.mag) == len(self) else self.mag,
            catalog=self.catalog[idx].copy() if len(self.catalog) == len(self) else self.catalog,
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
        magnitudes).  ``rename(k, tid)`` maps the k-th input's trajectory id
        to the output id, required when the same id occurs in several inputs
        (the escalation path merging failures of a dataset stream); default
        keeps ids unchanged.  Identical observers are merged by value."""
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
