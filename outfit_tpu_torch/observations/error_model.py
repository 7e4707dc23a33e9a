# Source: outfit_tpu/observations/error_model.py (copied; the VFCC17 table is read by path).
"""Astrometric error models and batch RMS correction.

FCCT14 (Farnocchia, Chesley, Chamberlin & Tholen 2015) assigns per-station
(and per-catalog) astrometric 1-sigma values, in arcsec.

Batch RMS correction: within each (trajectory, station) group, observations
closer than ``gap_max`` days form a batch; each member's sigma is inflated
by sqrt(batch size).
"""

import os
from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from outfit_tpu_torch.constants import RADSEC

#: the published VFCC17 table, shared with the JAX package as a data file
#: (read by path: importing that package would need JAX)
VFCC17_CSV = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "outfit_tpu", "observations", "data", "vfcc17_weights.csv",
)

#: FCCT14-style station weights (arcsec, both RA*cos(dec) and Dec)
_FCCT14_STATION = {
    "703": 1.0,
    "691": 0.6,
    "291": 0.6,
    "F51": 0.2,
    "F52": 0.2,
    "G96": 0.5,
    "G45": 0.6,
    "704": 1.0,
    "E12": 0.75,
    "W84": 0.15,
    "X05": 0.1,
    "T05": 0.5,
    "T08": 0.5,
    "M22": 0.5,
    "W68": 0.5,
    "568": 0.25,
    "D29": 0.75,
    "705": 0.3,
    "695": 0.5,
    "V00": 0.5,
}

#: FCCT14 per-(station, catalog-flag) overrides (arcsec)
_FCCT14_STATION_CATALOG: Dict[tuple, float] = {
    ("F51", "t"): 0.15,
    ("F52", "t"): 0.15,
    ("G96", "U"): 0.3,
    ("G96", "V"): 0.3,
    ("703", "U"): 0.8,
    ("703", "V"): 0.8,
}


@dataclass
class ErrorModel:
    """Per-station astrometric error model (sigmas in arcsec).

    Lookup hierarchy per observation: time-dependent
    ``(station, [mjd0, mjd1), catalog)`` rules -> ``(station, catalog)`` ->
    ``station`` -> ``default_arcsec``.
    """

    default_arcsec: float = 1.0
    station_arcsec: Dict[str, float] = field(default_factory=lambda: dict(_FCCT14_STATION))
    station_catalog_arcsec: Dict[tuple, float] = field(
        default_factory=lambda: dict(_FCCT14_STATION_CATALOG)
    )
    #: time-dependent rules: station -> [(mjd0, mjd1, catalog-or-'*', arcsec)]
    station_rules: Dict[str, list] = field(default_factory=dict)

    @classmethod
    def fcct14(cls) -> "ErrorModel":
        model = cls()
        path = os.environ.get("OUTFIT_FCCT14")
        if path and os.path.exists(path):
            model.load_table(path)
        return model

    @classmethod
    def vfcc17(cls) -> "ErrorModel":
        """The published Vereš, Farnocchia, Chesley & Chamberlin (2017)
        weighting scheme, including its time-dependent survey rules."""
        model = cls(station_arcsec={}, station_catalog_arcsec={})
        model.load_rules(VFCC17_CSV)
        path = os.environ.get("OUTFIT_FCCT14")
        if path and os.path.exists(path):
            model.load_table(path)
        return model

    def load_rules(self, path: str) -> "ErrorModel":
        """Load time-dependent rules from a CSV with lines
        ``station,mjd_start,mjd_end,catalog,arcsec`` (empty mjd = open
        interval; catalog ``*`` = any)."""
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = [p.strip() for p in line.split(",")]
                if len(parts) != 5:
                    continue
                station, m0, m1, cat, val = parts
                lo = float(m0) if m0 else -np.inf
                hi = float(m1) if m1 else np.inf
                self.station_rules.setdefault(station, []).append(
                    (lo, hi, cat or "*", float(val))
                )
                if not m0 and not m1 and cat in ("*", ""):
                    self.station_arcsec[station] = float(val)
        # first match wins: most-specific rules first
        for rules in self.station_rules.values():
            rules.sort(
                key=lambda r: (r[2] == "*", r[0] == -np.inf and r[1] == np.inf)
            )
        return self

    def load_table(self, path: str) -> "ErrorModel":
        """Merge an FCCT14 table from a CSV file with lines
        ``station,catalog,arcsec`` (catalog ``*`` = station-level)."""
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = [p.strip() for p in line.split(",")]
                if len(parts) != 3:
                    continue
                station, cat, val = parts
                if cat in ("*", ""):
                    self.station_arcsec[station] = float(val)
                else:
                    self.station_catalog_arcsec[(station, cat)] = float(val)
        return self

    @classmethod
    def constant(cls, arcsec: float) -> "ErrorModel":
        return cls(
            default_arcsec=arcsec, station_arcsec={}, station_catalog_arcsec={}
        )

    @classmethod
    def from_name(cls, name: str) -> "ErrorModel":
        """``"fcct14"``, ``"vfcc17"`` or ``"constant:<arcsec>"``."""
        from outfit_tpu_torch.errors import InvalidErrorModel

        key = name.strip().lower()
        if key == "fcct14":
            return cls.fcct14()
        if key == "vfcc17":
            return cls.vfcc17()
        if key.startswith("constant:"):
            try:
                return cls.constant(float(key.split(":", 1)[1]))
            except ValueError as e:
                raise InvalidErrorModel(f"bad constant error model {name!r}") from e
        raise InvalidErrorModel(f"unknown error model {name!r}")

    def _arcsec_one(self, code, cat, mjd):
        rules = self.station_rules.get(code)
        if rules and mjd is not None:
            for lo, hi, rcat, val in rules:
                if lo <= mjd < hi and (rcat == "*" or rcat == cat):
                    return val
        if cat is not None:
            v = self.station_catalog_arcsec.get((code, cat))
            if v is not None:
                return v
        return self.station_arcsec.get(code, self.default_arcsec)

    def sigma_rad(self, station_codes, catalogs=None, mjd=None) -> np.ndarray:
        """Per-observation sigma (radians) for RA*cos(dec) and Dec alike."""
        n = len(station_codes)
        cats = catalogs if catalogs is not None else [None] * n
        mjds = mjd if mjd is not None else [None] * n
        out = np.array(
            [
                self._arcsec_one(c, k, t)
                for c, k, t in zip(station_codes, cats, mjds)
            ]
        )
        return out * RADSEC


def batch_rms_correction(mjd, traj_idx, obs_idx, sigma, gap_max_days: float):
    """Inflate sigmas by sqrt(batch size) within same-(trajectory, station)
    groups of observations separated by <= gap_max_days."""
    mjd = np.asarray(mjd)
    sigma = np.asarray(sigma, dtype=np.float64).copy()
    n = len(mjd)
    if n == 0:
        return sigma
    traj_idx = np.asarray(traj_idx)
    obs_idx = np.asarray(obs_idx)
    order = np.lexsort((mjd, obs_idx, traj_idx))
    t_s = traj_idx[order]
    o_s = obs_idx[order]
    m_s = mjd[order]
    new_batch = np.ones(n, dtype=bool)
    same_group = (t_s[1:] == t_s[:-1]) & (o_s[1:] == o_s[:-1])
    new_batch[1:] = ~(same_group & (np.diff(m_s) <= gap_max_days))
    bid = np.cumsum(new_batch) - 1
    factor = np.sqrt(np.bincount(bid))[bid]
    sigma[order] *= factor
    return sigma
