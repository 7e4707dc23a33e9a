# Source: outfit_tpu/time/scales.py (trimmed: no download; numpy only).
"""UTC/TAI/TT/UT1 scale conversions for MPC epochs.

Implemented from the public IERS leap-second table; TT = TAI + 32.184 s.
Conversions run host-side during dataset preparation.
"""

from __future__ import annotations

import datetime as _dt
import math
from dataclasses import dataclass, field

import numpy as np

from outfit_tpu_torch.constants import JDTOMJD

#: (mjd_utc_threshold, TAI-UTC seconds) — IERS leap second table, 1972-2017+.
_LEAP_TABLE = np.array(
    [
        (41317.0, 10.0),  # 1972-01-01
        (41499.0, 11.0),  # 1972-07-01
        (41683.0, 12.0),  # 1973-01-01
        (42048.0, 13.0),  # 1974-01-01
        (42413.0, 14.0),  # 1975-01-01
        (42778.0, 15.0),  # 1976-01-01
        (43144.0, 16.0),  # 1977-01-01
        (43509.0, 17.0),  # 1978-01-01
        (43874.0, 18.0),  # 1979-01-01
        (44239.0, 19.0),  # 1980-01-01
        (44786.0, 20.0),  # 1981-07-01
        (45151.0, 21.0),  # 1982-07-01
        (45516.0, 22.0),  # 1983-07-01
        (46247.0, 23.0),  # 1985-07-01
        (47161.0, 24.0),  # 1988-01-01
        (47892.0, 25.0),  # 1990-01-01
        (48257.0, 26.0),  # 1991-01-01
        (48804.0, 27.0),  # 1992-07-01
        (49169.0, 28.0),  # 1993-07-01
        (49534.0, 29.0),  # 1994-07-01
        (50083.0, 30.0),  # 1996-01-01
        (50630.0, 31.0),  # 1997-07-01
        (51179.0, 32.0),  # 1999-01-01
        (53736.0, 33.0),  # 2006-01-01
        (54832.0, 34.0),  # 2009-01-01
        (56109.0, 35.0),  # 2012-07-01
        (57204.0, 36.0),  # 2015-07-01
        (57754.0, 37.0),  # 2017-01-01
    ]
)
_LEAP_MJD = _LEAP_TABLE[:, 0]
_LEAP_SEC = _LEAP_TABLE[:, 1]

#: TT - TAI offset in seconds (definition)
TT_MINUS_TAI = 32.184


def tai_minus_utc(mjd_utc):
    """TAI - UTC in seconds at the given UTC MJD(s) (clamped to 10 s
    before 1972)."""
    mjd_utc = np.asarray(mjd_utc, dtype=np.float64)
    idx = np.searchsorted(_LEAP_MJD, mjd_utc, side="right") - 1
    idx = np.clip(idx, 0, len(_LEAP_SEC) - 1)
    return _LEAP_SEC[idx]


def utc_mjd_to_tt(mjd_utc):
    """MJD(UTC) -> MJD(TT)."""
    mjd_utc = np.asarray(mjd_utc, dtype=np.float64)
    return mjd_utc + (tai_minus_utc(mjd_utc) + TT_MINUS_TAI) / 86400.0


def tt_mjd_to_utc(mjd_tt):
    """MJD(TT) -> MJD(UTC) (fixed-point on the step table; exact away from
    leap-second boundaries)."""
    mjd_tt = np.asarray(mjd_tt, dtype=np.float64)
    # One round of correction suffices: the table step is ~1s/year.
    guess = mjd_tt - (tai_minus_utc(mjd_tt) + TT_MINUS_TAI) / 86400.0
    return mjd_tt - (tai_minus_utc(guess) + TT_MINUS_TAI) / 86400.0


def mjd_to_jd(mjd):
    """MJD -> JD (same time scale).  Parity: ``src/time.rs:213-217``."""
    return np.asarray(mjd, dtype=np.float64) + JDTOMJD


def jd_to_mjd(jd):
    """JD -> MJD (same time scale).  Parity: ``src/time.rs:228-232``."""
    return np.asarray(jd, dtype=np.float64) - JDTOMJD


def utc_jd_to_tt_mjd(jd_utc):
    """JD(UTC) -> MJD(TT).  Parity: ``src/time.rs:259-264``."""
    return utc_mjd_to_tt(jd_to_mjd(jd_utc))


def _datetime_to_mjd_utc(dt: _dt.datetime) -> float:
    delta = dt - _dt.datetime(1858, 11, 17, 0, 0, 0)
    return delta.days + (delta.seconds + delta.microseconds * 1e-6) / 86400.0


def date_to_mjd(dates):
    """ISO calendar strings ``YYYY-MM-DDTHH:mm:ss`` (UTC) -> MJD(UTC).
    Parity: ``src/time.rs:198-202``."""
    return np.array([_datetime_to_mjd_utc(_dt.datetime.fromisoformat(s)) for s in dates])


def frac_date_to_mjd(date_str: str) -> float:
    """``YYYY MM DD.FFFFF`` (UTC) -> MJD(TT), the MPC 80-column epoch."""
    parts = date_str.split()
    if len(parts) != 3:
        raise ValueError("Invalid format, expected: YYYY MM DD.FFFFF")
    year = int(parts[0])
    month = int(parts[1])
    day_fraction = float(parts[2])
    day = int(day_fraction)
    fraction = day_fraction - day
    dt = _dt.datetime(year, month, day)
    mjd_utc = _datetime_to_mjd_utc(dt) + fraction
    return float(utc_mjd_to_tt(mjd_utc))


def _mjd_to_datetime(mjd: float) -> tuple:
    base = _dt.datetime(1858, 11, 17)
    days = math.floor(mjd)
    frac = mjd - days
    dt = base + _dt.timedelta(days=days)
    secs = frac * 86400.0
    return dt, secs


def _fmt_ss(seconds: float, prec: int) -> str:
    """Two-digit zero-padded seconds with ``prec`` fractional digits.
    Parity: ``src/time.rs:122-128``."""
    pow10 = 10**prec
    total = round(seconds * pow10)
    whole, fracpart = divmod(total, pow10)
    return f"{whole:02d}.{fracpart:0{prec}d}"


def _iso_from_mjd(mjd: float, prec: int) -> str:
    dt, secs = _mjd_to_datetime(mjd)
    hours, rem = divmod(secs, 3600.0)
    minutes, seconds = divmod(rem, 60.0)
    # carry on rounding
    if round(seconds * 10**prec) >= 60 * 10**prec:
        seconds = 0.0
        minutes += 1
        if minutes >= 60:
            minutes = 0
            hours += 1
            if hours >= 24:
                hours = 0
                dt = dt + _dt.timedelta(days=1)
    ss = _fmt_ss(seconds, prec)
    return f"{dt.year:04d}-{dt.month:02d}-{dt.day:02d}T{int(hours):02d}:{int(minutes):02d}:{ss}"


def iso_tt_from_mjd(mjd_tt: float, prec: int = 3) -> str:
    """Format MJD(TT) as ``YYYY-MM-DDThh:mm:SS.sss TT``."""
    return _iso_from_mjd(float(mjd_tt), prec) + " TT"


def iso_utc_from_mjd_tt(mjd_tt: float, prec: int = 3) -> str:
    """Format MJD(TT) as UTC ISO-8601 with trailing Z."""
    return _iso_from_mjd(float(tt_mjd_to_utc(mjd_tt)), prec) + "Z"


@dataclass
class Ut1Provider:
    """UT1 - UTC (DUT1) provider: a piecewise-linear table (mjd_utc,
    dut1_seconds) from a local IERS ``finals2000A`` file, otherwise
    DUT1 = 0 (|error| < 0.9 s -> < 2e-10 AU of observer position)."""

    mjd: np.ndarray = field(default_factory=lambda: np.array([0.0, 1e9]))
    dut1: np.ndarray = field(default_factory=lambda: np.zeros(2))

    @classmethod
    def from_finals2000a(cls, path: str) -> "Ut1Provider":
        """Parse a local IERS finals2000A.all (IAU2000) fixed-width file."""
        mjds, dut1s = [], []
        with open(path) as fh:
            for line in fh:
                if len(line) < 68:
                    continue
                try:
                    mjd = float(line[7:15])
                    val = float(line[58:68])
                except ValueError:
                    continue
                mjds.append(mjd)
                dut1s.append(val)
        if not mjds:
            return cls()
        return cls(np.array(mjds), np.array(dut1s))

    def dut1_seconds(self, mjd_utc):
        return np.interp(np.asarray(mjd_utc, dtype=np.float64), self.mjd, self.dut1)

    def utc_mjd_to_ut1(self, mjd_utc):
        mjd_utc = np.asarray(mjd_utc, dtype=np.float64)
        return mjd_utc + self.dut1_seconds(mjd_utc) / 86400.0

    def tt_mjd_to_ut1(self, mjd_tt):
        utc = tt_mjd_to_utc(mjd_tt)
        return self.utc_mjd_to_ut1(utc)
