# Source: outfit_tpu/observations/dataset.py (trimmed to MPC 80-column ingestion,
# error models and the batch RMS correction).
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
