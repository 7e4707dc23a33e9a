# Source: outfit_tpu/observations/dataset.py (trimmed to MPC 80-column ingestion,
# push_observation, subset, error models and the batch RMS correction).
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

    def trajectory_obs_indices(self, traj_id: str) -> np.ndarray:
        """Observation indices of one trajectory, sorted by epoch."""
        try:
            ti = self.traj_ids.index(traj_id)
        except ValueError:
            from outfit_tpu_torch.errors import TrajectoryIdNotFound

            raise TrajectoryIdNotFound(traj_id) from None
        idx = np.nonzero(self.traj_index == ti)[0]
        return idx[np.argsort(self.mjd_tt[idx], kind="stable")]
